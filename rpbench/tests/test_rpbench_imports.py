"""Nothing the benchmark runs imports JAX or the JAX package; the plain
reference imports nothing of the program either.  Top-level module names
are compared whole: the port's ``repro_torch`` begins with ``repro``."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_walks_every_module():
    names = {p.relative_to(HERE).as_posix() for p in MODULES}
    assert {"run.py", "control.py", "reference/release_ref.py",
            "loops/release_loop.py", "loops/served_closed_loop.py",
            "metrics/kernel_roofline_pct.release.py"} <= names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_jax_by_top_level_name(path):
    bad = top_level_imports(path) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | {"repro_torch"}), names
    assert names <= {"__future__", "itertools", "math", "collections",
                     "typing", "numpy", "torch"}, names


def test_top_level_names_compare_whole(bench):
    """repro_torch is the port, not the JAX package."""
    mods = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = object()
        assert "repro" not in bench.forbidden_modules()
        sys.modules["repro.core"] = object()
        assert bench.forbidden_modules() == ["repro"]
    finally:
        for k in set(sys.modules) - set(mods):
            del sys.modules[k]


def test_a_run_loads_no_jax(bench, tiny_cell):
    """A whole run on the CPU, in a fresh interpreter: nothing it loads is
    JAX or the JAX package."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(HERE.parent)!r}, {str(HERE.parent / 'src')!r}]\n"
        "from rpbench import run\n"
        "run.set_environment(run.ROOT)\n"
        "from rpbench.harness import spec\n"
        "cell = spec.load_cell(spec.load_benchmark(), 'adult-3way.release')\n"
        f"cell.config = json.load(open({str(HERE / 'tests/data/tiny-3way.json')!r}))\n"
        "res, _ = run.run_cell(cell, 11, 0.3, True, device='cpu', log=lambda m: None)\n"
        "assert res['correct'], res\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN and "repro_torch" in loaded
