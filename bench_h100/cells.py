"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root names a cell's configuration and traffic mix; `configs/<config>.json`
holds the configuration's sizes and precision, `mixes/<mix>.json` the
traffic's parameters, `limits/<cell>.json` the limits `correct` is judged
by, and `metrics/<metric>.py` one reader a per-layer metric. A later cell,
mix, configuration or metric is a new file and a new entry.

A configuration's decoder family (its top-level `"family"`, `FAMILY`
without one) names two modules, imported by name: `reference/<family>.py`,
the plain decoder whose `served_logits` the judge holds served tokens
against, and `counts/<family>.py`, whose `call_ops` counts the decoder's
model operations in a served call (`roofline.sot_call_ops`). A new family
is those two files, its configuration and its cells."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FAMILY = "llama"        # the decoder family of a configuration that names none


def read_json(kind: str, name: str, base: Path = HERE) -> dict:
    return json.loads((base / kind / f"{name}.json").read_text())


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    mix_name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    base: Path = HERE


def _reported(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    base = root / HERE.name
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reported(m, name, names)]
    return Cell(name=name, chips=w["chips"], config_name=w["config"],
                mix_name=w["traffic"],
                config=read_json("configs", w["config"], base),
                mix=read_json("mixes", w["traffic"], base),
                limits=read_json("limits", name, base), end_to_end=e2e,
                per_layer=per_layer, base=base)


def metric_reader(name: str, base: Path = HERE) -> Callable:
    """`read(records)` of metrics/<name>.py."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_h100_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(config: dict) -> str:
    return config.get("family", FAMILY)


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: metric_reader(m["name"], cell.base)
            for m in cell.per_layer}
