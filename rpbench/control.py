#!/usr/bin/env python3
"""The controls of the comparison that decides ``correct``: each has to
come out not correct.  They are not part of a benchmark run.

    python3 rpbench/control.py --workload NAME --seeds N [N ...] --seconds S

For each seed, through the same run as ``rpbench/run.py`` (inputs, set-up,
window, check), once for each control:

* ``program-bf16``: the program with its own lower-precision path on
  (``REPRO_KERNEL_COMPUTE_DTYPES=bfloat16``: reconstruction chains with
  bfloat16 operands, float32 sums; measurement chains stay float32);
* ``reference-lower``: the plain reference put in the program's place and
  computed one precision below what the configuration states (the plan in
  float32 for float64, the chains in bfloat16 for float32).

Each run prints the numbers compared beside their limits; the last line
is one JSON object with every reading.  Needs a card, as a run does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from rpbench import run as bench  # noqa: E402


class LowerPlan:
    """The reference's plan at the lower precision, as the check reads a
    plan: ``sigmas[clique]``."""

    def __init__(self, sizes, k, include_lower, plan_cfg):
        import numpy as np

        from rpbench.harness import inputs
        from rpbench.reference import release_ref as ref
        wl = inputs.workload_cliques(len(sizes), k, include_lower)
        cl, sig = ref.sov_sigma2(sizes, wl, float(plan_cfg["budget"]),
                                 np.float32)
        self.sigmas = dict(zip(cl, sig.astype(float).tolist()))
        self.sizes, self.workload = sizes, wl
        self.budget = float(plan_cfg["budget"])


class LowerEngine:
    """The reference in the program's place, its chains in bfloat16, on the
    plan it is given; ``release`` reads the noise seed off the generator."""

    def __init__(self, plan: LowerPlan, device):
        import numpy as np
        import torch

        from rpbench.harness.check import ReleaseCheck
        self.check = ReleaseCheck(plan.sizes, plan.workload, plan.budget,
                                  device, dtype=torch.bfloat16,
                                  plan_dtype=np.float32)

    def release(self, marginals, gen):
        om, tab = self.check.reference(marginals, gen.initial_seed())
        meas = {c: SimpleNamespace(omega=row) for cl, t in om.values()
                for c, row in zip(cl, t.float().cpu().numpy())}
        tables = {c: row for cl, t in tab.values()
                  for c, row in zip(cl, t.float().cpu().numpy())}
        return tables, meas


def controls():
    """{name: (planner, engine factory, compute dtypes)}."""
    return {"program-bf16": (bench.program_planner, bench.program_engine,
                             "bfloat16"),
            "reference-lower": (LowerPlan, LowerEngine, "float32")}


def run_control(cell, name, seed, seconds, device="cuda"):
    planner, factory, dtypes = controls()[name]
    os.environ["REPRO_KERNEL_COMPUTE_DTYPES"] = dtypes
    try:
        result, lines = bench.run_cell(cell, seed, seconds, False, device=device,
                                       planner=planner, engine_factory=factory)
    finally:
        os.environ["REPRO_KERNEL_COMPUTE_DTYPES"] = "float32"
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--only", choices=sorted(controls()), default=None)
    args = ap.parse_args(argv)
    bench.set_environment(ROOT)
    import torch

    from rpbench.harness import spec
    cell = spec.load_cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    readings = []
    for seed in args.seeds:
        for name in ([args.only] if args.only else sorted(controls())):
            result, lines = run_control(cell, name, seed, args.seconds)
            print(f"[{name}] seed {seed} correct {result['correct']}: "
                  + "; ".join(lines), flush=True)
            readings.append({"control": name, "seed": seed,
                             "correct": result["correct"],
                             "checks": result["checks"]})
    print(json.dumps({"workload": args.workload, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
