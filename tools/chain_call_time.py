#!/usr/bin/env python3
"""Per-call time of the port's chain kernels on one NVIDIA GPU.

    python3 tools/chain_call_time.py [--src DIR] [--reps N]
    python3 tools/chain_call_time.py --kernels --src A --src B [--rounds N]
                                     [--reps N] [--out FILE]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so two
source trees can be compared on one card.

Without ``--kernels`` it times ``fused_chain_matvec`` at two small-batch
chains of ResidualPlanner+, where the wrapper's host work can outweigh the
kernel:

* (a) Synth-10^20's range 3-way reconstruct chain: 1,140 rows of
  (10, 10, 10), T_10 on every axis, 'cumsum' on all three;
* (b) a (9, 85) chain, identity then T_85, 'cumsum' on both, 255 rows.

For each it prints one JSON line: the mean wall time of a call on the host
clock (each call followed by a synchronise), the mean time per call of
back-to-back calls from CUDA events, and the kernel time per call from
torch.profiler's device events.

With ``--kernels`` it times the kernels themselves at the main path's
largest launches, untuned (``REPRO_KERNEL_AUTOTUNE=off``, so every tree runs
its own default plan):

* ``synth_measure``: Synth-10^100's 3-way measure chain, 323,400 rows,
  Sub_10 on three axes, fused, float32;
* ``synth_reconstruct``: its 3-way reconstruct chain, 161,700 rows, fused,
  at float32, bfloat16 and float16 (``synth_reconstruct_bf16`` / ``_fp16``);
* ``rplus_a``: case (a) above, fused with the 'cumsum' epilogue;
* ``adult_wide``: Adult's (100, 100) reconstruct chain, 3 rows, T factors,
  held on the fused kernel (``smem_budget`` given, so no tuner): one row a
  block, the widest chain that fits it;
* ``adult_axis``: Adult's (100, 100, 100) measure chain on 2 rows through
  the per-axis kernel, 3 launches a call.

Each case reports the device time per call (the profiler's time in the
case's kernels, by kernel name), the CUDA-event time per call over
back-to-back calls, its launches and the card's clocks sampled right after.
Given several ``--src``, it runs one child process per tree in alternated
order (A B B A, ``--rounds`` times) and ends with one JSON line of medians
per case and tree, with the card's name and power limit.  It needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

KERNEL_NAMES = ("fused_chain_kernel", "kron_axis_kernel")


def _nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "not read"


def _device_kernel_ms(fn, reps: int, tries: int = 5) -> float:
    """Time per call of ``fn`` in the chain kernels, from torch.profiler's
    device events (the wrapper's copies and any other kernel left out).

    The profiler can drop kernel events (seen: 7 of 10 launches recorded
    in a session after busy ones), so a session is taken again, up to
    ``tries`` times, until it holds as many chain-kernel events as the
    wrappers counted launches; raises if it never does."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.kron_matvec.stats import chain_stats

    def launched():
        st = chain_stats()
        return st["fused_launches"] + st["axis_launches"]

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        before = launched()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if any(k in ev.key for k in KERNEL_NAMES)]
        if sum(ev.count for ev in evs) == launched() - before:
            return sum(ev.self_device_time_total for ev in evs) / 1e3 / reps
    raise RuntimeError("the profiler kept dropping kernel events")


def _event_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _t_factor(kind, n):
    import numpy as np
    from repro_torch.core.plus import attr_basis, build_w, s_hierarchical
    b = attr_basis(build_w(kind, n), s_hierarchical(n))
    return np.hstack([b.sub_pinv, np.full((n, 1), 1.0 / n)])


def wrapper_cases(src: str, reps: int) -> int:
    import numpy as np
    import torch
    from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("a", [_t_factor("range", 10)] * 3, (10, 10, 10), 1140),
             ("b", [None, _t_factor("prefix", 85)], (9, 85), 255)]
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
        for _ in range(reps):
            call()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        print(json.dumps(dict(
            case=name, src=src,
            autotune=os.environ.get("REPRO_KERNEL_AUTOTUNE", "model"),
            host_ms=host_ms, event_ms=_event_ms(call, reps),
            kernel_ms=_device_kernel_ms(call, reps), fused_launches=launches,
            card=torch.cuda.get_device_name(0))))
    return 0


def kernel_cases(src: str, reps: int) -> int:
    """One JSON line per kernel case of this tree (see the module note)."""
    import math

    import torch
    from repro_torch.core.reconstruct import u_chain_factors
    from repro_torch.core.residual import sub_matrix
    from repro_torch.data.tabular import synth_domain
    from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec
    from repro_torch.kernels.kron_matvec.ops import kron_matvec_kernel
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    os.environ["REPRO_KERNEL_AUTOTUNE"] = "off"
    gen = torch.Generator(device="cuda").manual_seed(0)
    n3 = math.comb(100, 3)
    recon = u_chain_factors(synth_domain(10, 3), (0, 1, 2))
    cube = (10, 10, 10)
    fused = [("synth_measure", [sub_matrix(10)] * 3, 2 * n3, None, None),
             ("synth_reconstruct", recon, n3, None, None),
             ("synth_reconstruct_bf16", recon, n3, None, "bfloat16"),
             ("synth_reconstruct_fp16", recon, n3, None, "float16"),
             ("rplus_a", [_t_factor("range", 10)] * 3, math.comb(20, 3),
              ("cumsum",) * 3, None)]
    cases = []
    for name, facs, batch, epi, cd in fused:
        x = torch.randn((batch, 1000), generator=gen, device="cuda")
        kw = {"epilogue": epi} if cd is None else {"epilogue": epi,
                                                  "compute_dtype": cd}
        cases.append((name, x, lambda f=facs, x=x, kw=kw:  # noqa: E731
                      fused_chain_matvec(f, x, cube, **kw)))
    from repro_torch.core import Domain
    wide = u_chain_factors(Domain.create([100, 100]), (0, 1))
    xw = torch.randn((3, 10 ** 4), generator=gen, device="cuda")
    cases.append(("adult_wide", xw, lambda: fused_chain_matvec(
        wide, xw, (100, 100), smem_budget=232448)))
    s100 = [None] + [sub_matrix(100)] * 3
    x = torch.randn((2 * 10 ** 6,), generator=gen, device="cuda")
    cases.append(("adult_axis", x, lambda: kron_matvec_kernel(
        s100, x, (2, 100, 100, 100))))
    for name, _x, call in cases:
        reset_chain_stats()
        call()
        torch.cuda.synchronize()
        st = chain_stats()
        r = max(5, reps // 10) if name.startswith("synth") else reps
        dev = _device_kernel_ms(call, r)
        ev = _event_ms(call, r)
        print(json.dumps(dict(
            case=name, src=src, device_ms=dev, event_ms=ev, reps=r,
            launches=st["fused_launches"] + st["axis_launches"],
            clocks=_nvidia_smi("clocks.sm,clocks.mem,power.draw,"
                               "temperature.gpu"))), flush=True)
    return 0


def compare(srcs, rounds: int, reps: int, out: str | None) -> int:
    """Children in alternated order (A B B A per round for two trees), then
    the medians of each case's device and event times per tree."""
    order = []
    for _ in range(rounds):
        order += srcs + srcs[::-1]
    runs = []
    for i, src in enumerate(order):
        cmd = [sys.executable, os.path.abspath(__file__), "--kernels",
               "--src", src, "--reps", str(reps)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                row = dict(json.loads(line), run=i)
                runs.append(row)
                print(json.dumps(row), flush=True)
    med = {}
    for row in runs:
        med.setdefault(row["case"], {}).setdefault(row["src"], []).append(row)
    summary = {}
    for case, by_src in med.items():
        summary[case] = {src: dict(
            device_ms=statistics.median(r["device_ms"] for r in rows),
            event_ms=statistics.median(r["event_ms"] for r in rows),
            device_runs=[r["device_ms"] for r in rows],
            launches=rows[0]["launches"],
            clocks=[r["clocks"] for r in rows]) for src, rows in by_src.items()}
    line = dict(medians=summary, order=order,
                card=_nvidia_smi("name,power.limit"))
    print(json.dumps(line))
    if out:
        with open(out, "w") as fh:
            json.dump(dict(runs=runs, **line), fh, indent=1)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=None,
                    help="source tree to import repro_torch from (repeat "
                         "with --kernels to compare trees)")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--kernels", action="store_true",
                    help="time the kernels at the main path's launches")
    ap.add_argument("--rounds", type=int, default=1,
                    help="--kernels with several --src: alternated rounds")
    ap.add_argument("--out", default=None,
                    help="--kernels with several --src: write every run here")
    args = ap.parse_args()
    srcs = args.src or [os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")]
    if args.kernels and len(srcs) > 1:
        return compare(srcs, args.rounds, args.reps, args.out)
    if len(srcs) > 1:
        ap.error("several --src need --kernels")
    src = srcs[0]
    sys.path.insert(0, os.path.abspath(src))
    import torch
    if not torch.cuda.is_available():
        print("chain_call_time: needs a CUDA device", file=sys.stderr)
        return 2
    return (kernel_cases if args.kernels else wrapper_cases)(src, args.reps)


if __name__ == "__main__":
    sys.exit(main())
