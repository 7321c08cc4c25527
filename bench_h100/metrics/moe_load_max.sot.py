"""How unevenly the router loads the experts: the program's counters
`mtasr.decoder.moe.pairs_max` (the sum over expert layers of the busiest
expert's pairs) times the experts a layer, over `mtasr.decoder.moe.pairs`
(the routed pairs), over the traced calls. 1.0 is an even load; the
grouped kernel's time follows the busiest expert. A program without the
counters gives nothing."""
from bench_h100 import program

PAIRS = "mtasr.decoder.moe.pairs"
PAIRS_MAX = "mtasr.decoder.moe.pairs_max"


def read(rec):
    v = program.view(rec)
    E = rec.geometry.get("decoder", {}).get("n_routed_experts")
    if not v or not E or not v.counts.get(PAIRS) or PAIRS_MAX not in v.counts:
        return None
    return v.counts[PAIRS_MAX] * E / v.counts[PAIRS]
