"""The command's contract where there is no card, and on the card."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "adult-3way.release", "--seed", str(2 ** 31 + 5),
        "--seconds", "2", "--trace", "0"]


def test_no_card_exits_nonzero_without_a_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "rpbench/run.py", *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "rpbench/run.py", *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"setup_s", "release_cells_per_s",
                                   "peak_device_gib"}
