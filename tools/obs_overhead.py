#!/usr/bin/env python3
"""Host microseconds per call of what tracing adds to the port, on one
NVIDIA GPU.

    PYTHONPATH=src python3 tools/obs_overhead.py [--calls N] [--rounds N]

Prints one JSON line with the host time per call of ``time.monotonic``,
``os.urandom(8)`` (a span draws two ids), an empty span written to the
JSONL sink, the bookkeeping that every untraced chain call does whether or
not anyone reads it (the no-op span and its check, the cached histogram
lookup, two clock reads, one histogram observation and two kernel-event
increments), and a (10, 10) ``fused_chain_matvec`` call of 8 rows on the
card untraced and traced (alternated ``--rounds`` times; medians), each
batch of ``--calls`` calls ended by a synchronise, beside the card's name
and power limit.  The trace goes to a temporary file that is removed.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    import torch
    from repro_torch.core.residual import sub_matrix
    from repro_torch.kernels.kron_matvec.fused import (_launch_series,
                                                       fused_chain_matvec)
    from repro_torch.kernels.kron_matvec.stats import CHAIN_STATS
    from repro_torch.obs import TRACER
    if not torch.cuda.is_available():
        raise SystemExit("obs_overhead: needs a CUDA device")

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / args.calls * 1e6

    def empty_span():
        with TRACER.span("obs.probe").set(i=1):
            pass

    def bookkeeping():
        t0 = time.monotonic()
        _, seconds = _launch_series((10, 10), 8, "float32")
        sp = TRACER.span("kernel.chain")
        if sp:
            sp.set(chain="probe")
        with sp:
            CHAIN_STATS.inc("fused_chains")
            CHAIN_STATS.inc("fused_launches")
        seconds.observe(time.monotonic() - t0)

    facs = [sub_matrix(10), sub_matrix(10)]
    x = torch.randn((8, 100), generator=torch.Generator("cuda").manual_seed(0),
                    device="cuda")

    def chain():
        fused_chain_matvec(facs, x, (10, 10))

    fd, path = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    out = {"monotonic": per_call(time.monotonic),
           "urandom(8)": per_call(lambda: os.urandom(8)),
           "untraced bookkeeping": per_call(bookkeeping)}
    try:
        TRACER.enable(path)
        out["empty span"] = per_call(empty_span)
        TRACER.disable()
        runs = {"chain off": [], "chain on": []}
        for _ in range(args.rounds):
            runs["chain off"].append(per_call(chain))
            TRACER.enable(path)
            runs["chain on"].append(per_call(chain))
            TRACER.disable()
    finally:
        TRACER.disable()
        os.remove(path)
    out.update({k: statistics.median(v) for k, v in runs.items()})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"us_per_call": out, "runs_us": runs, "card": card}))


if __name__ == "__main__":
    main()
