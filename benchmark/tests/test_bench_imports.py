"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference and the work count import nothing of the program. Names are
compared whole (the part before the first dot): the port's name begins
with the JAX package's."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "option_pricing_ffn_lbfgs_tpu"}
PROGRAM = "option_pricing_ffn_lbfgs_tpu_torch"


def top_level_imports(path: Path):
    """The top-level names of the absolute imports in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("part", ["reference", "workcount"])
def test_yardstick_imports_nothing_of_the_program(part):
    for path in sorted((BENCH / part).rglob("*.py")):
        assert PROGRAM not in top_level_imports(path), path


def test_whole_names_are_compared(monkeypatch):
    assert "option_pricing_ffn_lbfgs_tpu" not in {PROGRAM.split(".")[0]}
    fake = {PROGRAM: object(), PROGRAM + ".ops": object(),
            "jaxtyping": object()}
    for name, module in fake.items():
        monkeypatch.setitem(sys.modules, name, module)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_loading_every_piece_loads_no_jax():
    """A fresh process that loads the harness, every configuration (and
    so the program), every metric and the reading tool finds no JAX in
    ``sys.modules``."""
    code = f"""
import sys
from pathlib import Path
from benchmark import harness, readings, run
b = harness.Bench(Path({str(ROOT)!r}))
for c in b.manifest["configs"]:
    b.config(c["name"])
for m in b.manifest["end_to_end"] + b.manifest["per_layer"]:
    b.reader(m["name"])
assert "{PROGRAM}" in sys.modules
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
