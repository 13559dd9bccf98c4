#!/usr/bin/env python3
"""Per-call time of the port's fused chain wrapper on one NVIDIA GPU.

    python3 tools/chain_call_time.py [--src DIR] [--reps N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so two
source trees can be compared in one run on one card, and times
``fused_chain_matvec`` at two small-batch chains of ResidualPlanner+, where the
wrapper's host work can outweigh the kernel:

* (a) Synth-10^20's range 3-way reconstruct chain: 1,140 rows of
  (10, 10, 10), T_10 on every axis, 'cumsum' on all three;
* (b) a (9, 85) chain, identity then T_85, 'cumsum' on both, 255 rows.

For each it prints one JSON line: the mean wall time of a call on the host
clock (each call followed by a synchronise), the mean time per call of
back-to-back calls from CUDA events, and the kernel time per call from
torch.profiler's device events.  It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.plus import attr_basis, build_w, s_hierarchical
    from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    if not torch.cuda.is_available():
        print("chain_call_time: needs a CUDA device", file=sys.stderr)
        return 2

    def t_factor(kind, n):
        b = attr_basis(build_w(kind, n), s_hierarchical(n))
        return np.hstack([b.sub_pinv, np.full((n, 1), 1.0 / n)])

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("a", [t_factor("range", 10)] * 3, (10, 10, 10), 1140),
             ("b", [None, t_factor("prefix", 85)], (9, 85), 255)]
    for name, facs, dims, batch in cases:
        x = torch.randn((batch, int(np.prod(dims))), generator=gen,
                        device="cuda")
        epi = ("cumsum",) * len(dims)

        def call():
            return fused_chain_matvec(facs, x, dims, epilogue=epi)

        for _ in range(10):
            call()
        torch.cuda.synchronize()
        reset_chain_stats()
        call()
        torch.cuda.synchronize()
        launches = chain_stats()["fused_launches"]
        t0 = time.perf_counter()
        for _ in range(args.reps):
            call()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / args.reps * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            call()
        end.record()
        torch.cuda.synchronize()
        event_ms = start.elapsed_time(end) / args.reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                call()
            torch.cuda.synchronize()
        kern_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                      if not ev.key.startswith(("Memcpy", "Memset")))
        print(json.dumps(dict(
            case=name, src=args.src,
            autotune=os.environ.get("REPRO_KERNEL_AUTOTUNE", "model"),
            host_ms=host_ms, event_ms=event_ms,
            kernel_ms=kern_us / 1e3 / args.reps, fused_launches=launches,
            card=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
