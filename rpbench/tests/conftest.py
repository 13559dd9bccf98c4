"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest -q rpbench/tests`` from the root of the checkout)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def bench():
    from rpbench import run
    run.set_environment(run.ROOT)
    return run


@pytest.fixture
def tiny_cell(bench):
    """adult-3way.release's cell with the tiny test configuration."""
    from rpbench.harness import spec

    def make(traffic="release", **overrides):
        cell = spec.load_cell(spec.load_benchmark(), "adult-3way.release")
        cell.config = json.loads((DATA / "tiny-3way.json").read_text())
        cell.traffic = json.loads(
            (ROOT / "rpbench" / "traffic" / f"{traffic}.json").read_text())
        cell.traffic.update(overrides)
        return cell
    return make


@pytest.fixture
def card():
    """Skips the test where there is no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
