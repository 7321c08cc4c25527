"""Nothing under bench_h100/ imports JAX or the JAX package, and the
reference and the decoder families' counts import nothing of the program
(top-level names compared whole: the port's name begins with the JAX
package's)."""
import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "mtasr_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    bad = {str(f.relative_to(HERE)): top_level_imports(f) & JAX_SIDE
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    files = sorted((HERE / "reference").rglob("*.py"))
    assert files
    for f in files:
        names = top_level_imports(f)
        assert "mtasr_tpu_torch" not in names, f
        assert not names & JAX_SIDE, f


def test_port_name_is_not_taken_for_the_jax_package():
    # the check compares whole top-level names: the port passes it
    assert "mtasr_tpu_torch".split(".")[0] not in JAX_SIDE


def test_family_counts_import_nothing_of_the_program():
    # a family's count reads shapes alone, as its reference reads weights
    files = sorted((HERE / "counts").rglob("*.py"))
    assert HERE / "counts" / "llama.py" in files
    for f in files:
        names = top_level_imports(f)
        assert "mtasr_tpu_torch" not in names, f
        assert not names & JAX_SIDE, f
