#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure exits non-zero:

1. Build both CUDA kernels from src/repro_torch/kernels/kron_matvec/csrc with
   nvcc (in parallel) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (rel 2e-5 of max|plain|), and time kernel, plain
   version and one torch.einsum call for the same function with CUDA events.
   Then check a small release against the float64 host oracles.
3. Adult, all <=3-way marginals: select_sum_of_variances -> MarginalEngine
   (device="cuda") -> release, marginals from seeded synthetic records.
   Every table within 6 sigma of the exact marginal; both kernels launched.
4. Synth-10^d (d = 100), all <=3-way: the same release over marginals of a
   seeded mixture; every table within 7 sigma (about 1.6e8 cells: at 6 sigma
   some 0.3 cells would exceed the bound by chance, at 7 sigma 4e-4).
5. Print the kernels line and, last, {"ok": true, "device": {...}}.

It imports torch, numpy and the port only.  Without CUDA it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

MEM_BW = 3.35e12      # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
FP32_PEAK = 67e12     # H100 SXM fp32 outside the tensor cores, FLOP/s
REL_TOL = 2e-5        # of max|plain|: fmaf vs separate mul/add rounding
SYNTH_D = 100
ADULT_RECORDS = 48842  # rows of the Adult data set
SEED = 0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` on the card over ``reps`` calls, after one warmup."""
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


def chain_work(factors, dims, batch):
    """(bytes, FLOP) of one fused launch: each row read once and written
    once, the factors read once; 2·m·n FLOP per output of every axis."""
    cur = list(dims)
    flops = 0
    for axis, s in enumerate(factors):
        m, n = s.shape
        flops += 2 * math.prod(cur[:axis]) * m * n * math.prod(cur[axis + 1:])
        cur[axis] = m
    nbytes = 4 * (batch * (math.prod(dims) + math.prod(cur))
                  + sum(s.size for s in factors))
    return nbytes, batch * flops


def bound(nbytes, flops):
    """(least ms, what bounds it) at the card's memory and fp32 rates."""
    t_mem, t_ops = nbytes / MEM_BW * 1e3, flops / FP32_PEAK * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def einsum_chain(factors, x, dims):
    """One torch.einsum call for the chain (timed as a yardstick only).
    x comes first so a left-to-right contraction is the per-axis chain."""
    letters = "ijklmn"[:len(dims)]
    outs = "abcdef"[:len(dims)]
    spec = (f"z{letters}," + ",".join(f"{o}{i}" for o, i in zip(outs, letters))
            + f"->z{outs}")
    return torch.einsum(spec, x.view(x.shape[0], *dims), *factors).reshape(
        x.shape[0], -1)


def phase_build():
    from repro_torch.kernels._build import build
    t0 = time.perf_counter()
    reports = build(["fused_chain", "kron_axis"], force=True)
    print(f"[build] both kernels built in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels(card):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core.reconstruct import u_chain_factors
    from repro_torch.core.residual import sub_matrix
    from repro_torch.data.tabular import synth_domain
    from repro_torch.kernels.kron_matvec.fused import (
        fused_chain_matvec, fused_chain_matvec_plain, plan_chain)
    from repro_torch.kernels.kron_matvec.ops import kron_matvec_kernel

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_cliques = math.comb(SYNTH_D, 3)
    synth3 = synth_domain(10, 3)
    cases = [
        ("fused_chain", "Synth-10^%d 3-way measure chain" % SYNTH_D,
         [sub_matrix(10)] * 3, (10, 10, 10), 2 * n_cliques),
        ("fused_chain", "Synth-10^%d 3-way reconstruct chain" % SYNTH_D,
         u_chain_factors(synth3, (0, 1, 2)), (10, 10, 10), n_cliques),
        ("kron_axis", "Adult (100,100,100) measure chain, 3 launches",
         [sub_matrix(100)] * 3, (100, 100, 100), 2),
    ]
    rows = []
    for name, label, facs, dims, batch in cases:
        s_facs = [np.asarray(s, np.float32) for s in facs]
        s_dev = [torch.as_tensor(s, device=dev) for s in s_facs]
        x = torch.randn((batch, math.prod(dims)), generator=gen, device=dev)
        if name == "fused_chain":
            if not plan_chain(s_facs, dims, batch=batch).fused_ok:
                raise AssertionError(f"{label} does not fit the fused kernel")
            kernel = lambda: fused_chain_matvec(s_facs, x, dims)  # noqa: E731
            nbytes, flops = chain_work(s_facs, dims, batch)
            bound_ms, bound_by = bound(nbytes, flops)
        else:
            if plan_chain(s_facs, dims, batch=batch).fused_ok:
                raise AssertionError(f"{label} fits the fused kernel")
            kernel = lambda: kron_matvec_kernel(  # noqa: E731
                [None] + s_facs, x.reshape(-1), (batch,) + dims).reshape(batch, -1)
            # Each launch is one call of the per-axis function: its input,
            # factor and output cross memory once.
            bound_ms, t_mem, t_ops = 0.0, 0.0, 0.0
            cur = [batch] + list(dims)
            for axis, s in enumerate(s_facs, start=1):
                m, n = s.shape
                L, R = math.prod(cur[:axis]), math.prod(cur[axis + 1:])
                nbytes = 4 * (L * n * R + m * n + L * m * R)
                flops = 2 * L * m * n * R
                bound_ms += bound(nbytes, flops)[0]
                t_mem += nbytes / MEM_BW * 1e3
                t_ops += flops / FP32_PEAK * 1e3
                cur[axis] = m
            bound_by = "operations" if t_ops >= t_mem else "bytes"
        plain = lambda: fused_chain_matvec_plain(s_facs, x, dims)  # noqa: E731
        library = lambda: einsum_chain(s_dev, x, dims)  # noqa: E731
        got, want, lib = kernel(), plain(), library()
        torch.cuda.synchronize()
        err = rel_err(got, want)
        abs_err = float((got - want).abs().max())
        lib_err = rel_err(lib, want)
        reps = 20 if batch > 1000 else 50
        ms, plain_ms, lib_ms = (time_ms(kernel, reps), time_ms(plain, reps),
                                time_ms(library, reps))
        print(f"[kernels] {name} | {label}: rel err {err:.3e} (einsum "
              f"{lib_err:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"einsum {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
              f"| {card}")
        if not err <= REL_TOL:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {label}: rel err {err:.3e}")
        rows.append(dict(name=name, case=label, max_abs_err=abs_err,
                         rel_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms))
        del x, got, want, lib
        torch.cuda.empty_cache()
    return rows


def phase_small_reference():
    """A small release on the card against the float64 host oracles, fed
    the same noise the card drew."""
    from repro_torch.core import (Domain, all_kway, draw_noise,
                                  exact_marginals_from_x, measure, measure_np,
                                  reconstruct_all, select_sum_of_variances)
    from repro_torch.engine import MarginalEngine

    dom = Domain.create([3, 5, 2, 7])
    plan = select_sum_of_variances(all_kway(dom, 3, include_lower=True), 1.0)
    x = np.random.default_rng(SEED).integers(0, 9, dom.universe_size())
    margs = exact_marginals_from_x(dom, plan.cliques, x)
    eng = MarginalEngine(plan, device="cuda")
    tables, meas = eng.release(margs, torch.Generator("cuda").manual_seed(7))
    loop = measure(plan, margs, torch.Generator("cuda").manual_seed(7),
                   batched=False, device="cuda")
    z = draw_noise(plan, torch.Generator("cuda").manual_seed(7), "cuda")

    class Replay:
        pos = 0
        flat = z.double().cpu().numpy()

        def standard_normal(self, n):
            out = self.flat[self.pos:self.pos + n]
            self.pos += n
            return out

    ref = measure_np(plan, margs, Replay())
    ref_tables = reconstruct_all(plan, ref)
    worst_m = worst_t = 0.0
    for c in plan.cliques:
        if not np.array_equal(meas[c].omega, loop[c].omega):
            raise AssertionError(f"batched and loop measurements differ on {c}")
        scale = max(np.abs(ref[c].omega).max(), 1.0)
        worst_m = max(worst_m, np.abs(meas[c].omega - ref[c].omega).max() / scale)
    for c in plan.workload.cliques:
        scale = max(np.abs(ref_tables[c]).max(), 1.0)
        worst_t = max(worst_t, np.abs(tables[c] - ref_tables[c]).max() / scale)
    print(f"[reference] sizes (3,5,2,7) <=3-way: batched == loop bit for bit; "
          f"measure rel err {worst_m:.2e}, reconstruct rel err {worst_t:.2e} "
          f"vs the float64 oracles")
    if not (worst_m < 1e-5 and worst_t < 1e-5):
        raise AssertionError("small release disagrees with the float64 oracles")


def check_tables(plan, tables, exact, k_sigma):
    """Every workload table finite, of its shape, within k_sigma of exact."""
    sd = np.sqrt(plan.variances_array())
    worst = 0.0
    for c, s in zip(plan.workload.cliques, sd):
        t = tables[c]
        if t.shape != (plan.domain.n_cells(c),) or not np.all(np.isfinite(t)):
            raise AssertionError(f"table {c} has shape {t.shape} or non-finite values")
        worst = max(worst, float(np.abs(t - exact[c]).max() / s))
    if not worst <= k_sigma:
        raise AssertionError(f"a table is {worst:.2f} sigma from its exact "
                             f"marginal (bound {k_sigma})")
    return worst


def release_phase(name, plan, make_marginals, k_sigma):
    from repro_torch.engine import MarginalEngine
    from repro_torch.kernels.kron_matvec.stats import (chain_stats,
                                                       reset_chain_stats)
    t0 = time.perf_counter()
    margs = make_marginals()
    secs = {"marginals": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    reset_chain_stats()
    t0 = time.perf_counter()
    eng = MarginalEngine(plan, device="cuda")
    secs["engine"] = time.perf_counter() - t0
    for step in ("measure", "reconstruct"):
        def timed(*a, _fn=getattr(eng, step), _step=step, **k):
            t = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            secs[_step] = time.perf_counter() - t
            return out
        setattr(eng, step, timed)
    tables, _meas = eng.release(margs, torch.Generator("cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    counts = chain_stats()
    t0 = time.perf_counter()
    worst = check_tables(plan, tables, margs, k_sigma)
    secs["check"] = time.perf_counter() - t0
    cells = sum(plan.domain.n_cells(c) for c in plan.workload.cliques)
    print(f"[{name}] closure {len(plan.cliques)} cliques, workload "
          f"{len(plan.workload.cliques)} marginals / {cells} cells, "
          f"{eng.stats.measure_signatures} measure + "
          f"{eng.stats.reconstruct_signatures} reconstruct signature groups, "
          f"fused chains {eng.stats.fused_chains}, per-axis chains "
          f"{eng.stats.fallback_chains}")
    print(f"[{name}] seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[{name}] worst table {worst:.3f} sigma (bound {k_sigma}); "
          f"launches {counts}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 2
    from repro_torch.core import all_kway, select_sum_of_variances
    from repro_torch.data.tabular import (adult_domain, marginals_from_records,
                                          mixture_marginals, synth_domain,
                                          synthetic_records)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    rows = phase_kernels(card)
    phase_small_reference()

    adult = adult_domain()
    plan = select_sum_of_variances(all_kway(adult, 3, include_lower=True), 1.0)
    adult_counts = release_phase(
        "adult", plan, lambda: marginals_from_records(
            adult, plan.cliques, synthetic_records(adult, ADULT_RECORDS, SEED)),
        6.0)
    if not (adult_counts["fused_launches"] > 0
            and adult_counts["axis_launches"] > 0):
        raise AssertionError(f"Adult release skipped a kernel: {adult_counts}")

    synth = synth_domain(10, SYNTH_D)
    t0 = time.perf_counter()
    splan = select_sum_of_variances(all_kway(synth, 3, include_lower=True), 1.0)
    print(f"[synth] select {time.perf_counter() - t0:.3f} s")
    synth_counts = release_phase(
        "synth", splan, lambda: mixture_marginals(
            synth, splan.cliques, 1e6, SEED), 7.0)
    if not synth_counts["fused_launches"] > 0:
        raise AssertionError(f"Synth release skipped the fused kernel: {synth_counts}")

    launches = {"fused_chain": adult_counts["fused_launches"]
                + synth_counts["fused_launches"],
                "kron_axis": adult_counts["axis_launches"]
                + synth_counts["axis_launches"]}
    sources = {"fused_chain": ("src/repro_torch/kernels/kron_matvec/csrc/fused_chain.cu",
                               "src/repro/kernels/kron_matvec/fused.py:262"),
               "kron_axis": ("src/repro_torch/kernels/kron_matvec/csrc/kron_axis.cu",
                             "src/repro/kernels/kron_matvec/kron_matvec.py:55")}
    kernels = []
    for name in ("fused_chain", "kron_axis"):
        mine = [r for r in rows if r["name"] == name]
        head = mine[0]
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            case=head["case"], cases=mine))
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
