"""Nothing the harness runs imports JAX or the JAX package, and the plain
reference imports no part of the program.  Module names are compared by
their top-level name, the part before the first dot, whole: the port's
name begins with the JAX package's."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from ttbench import harness

BENCH = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "tt_sketch_tpu"}
NOT_THE_YARDSTICK = {"chip_smoke", "chip_smoke_dist", "tools", "bench"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_forbidden_import(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN
    assert not names & NOT_THE_YARDSTICK
    if "reference" in path.relative_to(BENCH).parts:
        assert "tt_sketch_torch" not in names
        assert names <= {"__future__", "math", "functools", "operator",
                         "typing", "numpy", "torch", "ttbench"}


def test_whole_names_are_compared():
    assert "tt_sketch_torch" not in FORBIDDEN
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def test_a_run_loads_no_forbidden_module(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(BENCH.parent)!r})
from ttbench import harness
from ttbench.tests import tiny
tiny.write_coo(__import__("pathlib").Path({str(tmp_path)!r}))
for name in tiny.CELLS:
    r = harness.run(tiny.cell(name), 5, 0.05, False, "cpu",
                    repo=__import__("pathlib").Path({str(tmp_path)!r}))
    assert r["correct"], (name, r)
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
