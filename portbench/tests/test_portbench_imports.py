"""No module of the benchmark, and no module a run loads, is JAX, flax or
the JAX package, compared by whole top-level name; the plain reference
loads nothing of the program either."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from tiny import CELLS, ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "grl_tpu"}


def imported_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    names = set(imported_names(path))
    assert not names & FORBIDDEN
    if path.parent.name == "reference":
        assert "grl_torch" not in names


def loaded_after(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build"), "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


TOP = "import json, sys; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def test_every_benchmark_module_loads_without_jax():
    code = ("import importlib.util, pathlib, sys\n"
            "for p in sorted(pathlib.Path('portbench').rglob('*.py')):\n"
            "    if p.parent.name == 'tests' or p.name in ('run.py', 'readings.py'): continue\n"
            "    name = 'portbench_module_' + str(len(sys.modules))\n"
            "    spec = importlib.util.spec_from_file_location(name, p)\n"
            "    sys.modules[name] = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(sys.modules[name])\n" + TOP)
    assert not loaded_after(code) & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = ("import pathlib, importlib\n"
            "for p in sorted(pathlib.Path('portbench/reference').glob('*.py')):\n"
            "    importlib.import_module('portbench.reference.' + p.stem)\n" + TOP)
    loaded = loaded_after(code)
    assert not loaded & (FORBIDDEN | {"grl_torch"})


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_no_jax(name):
    code = (f"import sys; sys.path.insert(0, 'portbench/tests'); import tiny\n"
            f"tiny.run(tiny.tiny_cell({name!r}))\n" + TOP)
    loaded = loaded_after(code)
    assert "grl_torch" in loaded and not loaded & FORBIDDEN
