#!/usr/bin/env python3
"""Run one cell of the benchmark once, and print its result as one JSON line.

    python3 rpbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``, ``rpbench/``
and the program (``src/repro_torch``).  The cell's entry in
``BENCHMARK.json`` names its configuration (``rpbench/configs/*.json``) and
its traffic mix (``rpbench/traffic/<mix>.json``, whose ``loop`` names
``rpbench/loops/<loop>.py``); each metric is read by
``rpbench/metrics/<metric>.py``.

A run: the exact marginal tables of the configuration's data, from the
seed; the program's plan (``plan_s``); the loop's set-up, which builds the
engine (``engine_build_s``; the first run in a checkout compiles the
kernels here) and warms it with one release; then the window of
``--seconds``.  With ``--trace 1`` the window is two halves: the first,
as untraced, gives the metrics whose source is ``host_clock``; the second
runs with the program's tracer on and under ``torch.profiler`` (device
activity alone on the card), and gives the other metrics, ``busy_s``,
``window_s`` and the breakdown.  After the window the device's peak is read, the
program's state is freed and the plain reference
(``rpbench/reference/release_ref.py``) checks what the window produced
(``rpbench/harness/check.py``): the plan, and the residual answers and
tables of a seeded sample of cliques in every release and of every clique
in the last.  The numbers compared are printed beside their limits, last on
standard error and under ``checks`` in the result.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones.  The result's ``setup`` gives the
seconds of each set-up phase and ``first_in_checkout``, true on the run
that found no earlier run's kernels and caches in the checkout.  Without a card (or with fewer than
the cell asks for) the run exits 2 and prints no result; if ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded when the window
has closed it exits 3.
"""
from __future__ import annotations

import time

T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the program's spans that the readers and the breakdown use
SPAN_NAMES = ("engine.measure", "engine.reconstruct", "kernel.chain",
              "serve.request", "serve.batch")


def process_age_s() -> float:
    """Seconds since this process started: the kernel's start time of the
    process (``/proc/self/stat``) against the boot clock.  Raises where
    that cannot be read or reads less than the time since this module was
    imported."""
    with open("/proc/self/stat", encoding="ascii") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - start
    if age < time.monotonic() - T_IMPORT - 0.02:
        raise RuntimeError(f"process age {age:.3f} s reads less than the "
                           "time since the harness was imported")
    return age


def set_environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout; the program as the
    configuration states it (float32 chains, its default tuner, no
    tracing from the environment)."""
    cache = root / "build" / "rpbench"
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache / "autotune")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["REPRO_KERNEL_COMPUTE_DTYPES"] = "float32"
    for key in ("REPRO_KERNEL_AUTOTUNE", "REPRO_TRACE"):
        os.environ.pop(key, None)
    os.environ.setdefault("USE_FLAX", "0")
    for p in (str(root), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def program_planner(sizes, k, include_lower, plan_cfg):
    """The program's plan of the configuration's workload."""
    from repro_torch.core.domain import Domain, all_kway
    from repro_torch.core.select import select_sum_of_variances
    if plan_cfg["objective"] != "sum_of_variances":
        raise ValueError(f"no reference for objective {plan_cfg['objective']!r}")
    wk = all_kway(Domain.create(sizes), k, include_lower=include_lower)
    return select_sum_of_variances(wk, float(plan_cfg["budget"]))


def program_engine(plan, device):
    from repro_torch.engine import MarginalEngine
    return MarginalEngine(plan, device=device)


def check_outputs(cfg, sizes, workload, dev, sigmas, kept, last, margs,
                  sample) -> dict:
    """The gaps of the program's plan and of the checked releases from the
    plain reference (``rpbench/harness/check.py``)."""
    from rpbench.harness import check
    chk = check.ReleaseCheck(sizes, workload, float(cfg["plan"]["budget"]), dev)
    gaps = {"sigma2_rel": chk.sigma2_gap(sigmas.__getitem__),
            "omega_rel": 0.0, "table_rel": 0.0}
    checked = [(margs[t], rseed, oms, tabs, sample)
               for t, rseed, oms, tabs in kept]
    checked += [(margs[t], rseed, {c: m.omega for c, m in meas.items()}, tabs,
                 None) for t, (rseed, tabs, meas) in last.items()]
    for margs_t, rseed, oms, tabs, cliques in checked:
        om, tab = chk.gaps(margs_t, rseed, oms, tabs, cliques)
        gaps["omega_rel"] = max(gaps["omega_rel"], om)
        gaps["table_rel"] = max(gaps["table_rel"], tab)
    return gaps


def device_kind(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             planner=program_planner, engine_factory=program_engine,
             log=None, root: Path = ROOT):
    """Run ``cell`` once; returns (result dict, check lines).  Loops and
    readers are found under ``root``."""
    import numpy as np
    import torch

    from rpbench.harness import inputs, spec, work
    from rpbench.harness.trace import Trace, mark

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    setup = {"startup_s": process_age_s()}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t = time.monotonic()
    torch.zeros(1, device=dev)
    setup["device_init_s"] = time.monotonic() - t
    cfg, tr = cell.config, cell.traffic
    sizes = [int(n) for n in cfg["domain"]["sizes"]]
    k, lower = int(cfg["workload"]["k"]), bool(cfg["workload"]["include_lower"])
    workload = inputs.workload_cliques(len(sizes), k, lower)
    closure = inputs.closure(workload)
    cells = sum(inputs.cells(sizes, c) for c in workload)
    workdir = root / "build" / "rpbench"
    workdir.mkdir(parents=True, exist_ok=True)
    # the first run in a checkout builds the kernels and fills the tuner's
    # cache: its set-up is marked in the result
    done_marker = workdir / "set_up"
    first_in_checkout = not done_marker.exists()

    t = time.monotonic()
    tenants = int(tr.get("tenants", 1))
    margs = [inputs.make_marginals(cfg["data"], sizes, closure,
                                   inputs.seed_int(seed, 100 + i))
             for i in range(tenants)]
    setup["inputs_s"] = time.monotonic() - t
    t = time.monotonic()
    plan = planner(sizes, k, lower, cfg["plan"])
    setup["plan_s"] = time.monotonic() - t

    seed_rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    sample_rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    n_sample = min(int(cfg["check"]["sample_tables"]), len(workload))
    sample = [workload[i] for i in sorted(
        sample_rng.choice(len(workload), n_sample, replace=False).tolist())]
    sample_cl = inputs.closure(sample)
    records, kept, last, spans = [], [], {}, []
    lock_seeds = threading.Lock()

    def seeds() -> int:
        with lock_seeds:
            return int(seed_rng.integers(0, 2 ** 63))

    tracer = None
    if trace:
        from repro_torch.obs import TRACER as tracer

    def drain():
        if tracer is not None:
            spans.extend((s.name, s.t0, s.t1) for s in tracer.drain()
                         if s.name in SPAN_NAMES and s.t1 is not None)

    def done(rec, tables, meas):
        with ctx.lock:
            records.append(rec)
            drain()
            if rec.error is not None:
                return
            kept.append((rec.tenant, rec.seed,
                         {c: np.array(meas[c].omega, copy=True) for c in sample_cl},
                         {c: np.array(tables[c], copy=True) for c in sample}))
            last[rec.tenant] = (rec.seed, tables, meas)

    loop = spec.load_module("loops", tr["loop"], root)
    ctx = spec.LoopContext(plan=plan, marginals=margs, traffic=tr, device=dev,
                           seconds=float(seconds), seeds=seeds, done=done,
                           workdir=workdir, engine_factory=engine_factory)
    state = loop.setup(ctx)
    setup.update(ctx.setup)
    done_marker.touch()
    if on_card:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        from repro_torch.kernels.kron_matvec.stats import reset_chain_stats
        reset_chain_stats()
    setup_s = process_age_s()
    w0 = time.monotonic()
    if trace:
        # Both slow the host-bound release: the window's first half runs
        # with neither and gives the metrics on the host's clock; its
        # second half runs with the program's tracer on and under the
        # profiler (device activity alone on the card), and gives the rest.
        ctx.seconds = float(seconds) / 2
        loop.run(ctx, state)
        quiet = (len(records), (w0, time.monotonic()))
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                   else ProfilerActivity.CPU])
        prof.__enter__()
        mark_ns = mark(dev)
        if on_card:
            reset_chain_stats()
        tracer.drain()
        tracer.enable()
        p0 = time.monotonic()
    loop.run(ctx, state)
    w1 = time.monotonic()
    if on_card:
        torch.cuda.synchronize(dev)
    if trace:
        tracer.disable()
        drain()
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    memory_peak = max(setup_peak, peak) if on_card else 0
    launches = None
    if on_card:
        from repro_torch.kernels.kron_matvec.stats import chain_stats
        st = chain_stats()
        launches = st["fused_launches"] + st["axis_launches"]

    # the program's plan, read before its state is freed
    sigmas = {}
    for c in closure:
        try:
            sigmas[c] = float(plan.sigmas[c])
        except KeyError:
            break
    loop.close(state)
    del state, ctx, plan
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    ok = [r for r in records if r.error is None]
    failed = [r for r in records if r.error is not None]
    for r in failed[:3]:
        log(f"[run] request failed: {r.error}")
    t = time.monotonic()
    gaps = check_outputs(cfg, sizes, workload, dev, sigmas, kept, last, margs,
                         sample)
    check_s = time.monotonic() - t
    limits = cfg["check"]["limits"]
    correct = (bool(ok) and not failed and len(last) == tenants
               and all(gaps[n] <= limits[n] for n in gaps))

    least_s = None
    peaks = work.PEAKS.get(device_kind(dev))
    if peaks is not None:
        least_s = work.release_least_seconds(sizes, closure, workload, peaks)

    def observe(recs, spans_, window, trace_=None):
        return spec.Observation(
            setup=setup, setup_s=setup_s,
            releases=[(r.t0, r.t1) for r in recs if r.error is None],
            cells=cells, peak_bytes=peak, spans=spans_, trace=trace_,
            window=window, least_s=least_s)

    device = {"platform": "gpu" if on_card else "cpu", "kind": device_kind(dev),
              "count": cell.chips if on_card else 1,
              "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(records),
              "failed": len(failed)}
    breakdown = None
    if trace:
        n_quiet, quiet_window = quiet
        obs = observe(records[:n_quiet], [], quiet_window)
        traced = records[n_quiet:]
        window = (p0, max([w1] + [r.t1 for r in traced]))
        traced_obs = observe(traced, spans, window,
                             Trace.from_profiler(prof, mark_ns).window(*window))
        device["busy_s"] = traced_obs.trace.busy(*window)
        device["window_s"] = window[1] - window[0]
        breakdown = {"device_ops": traced_obs.trace.top_ops(),
                     "idle_gaps": traced_obs.trace.top_gaps(*window, spans)}
        if launches is not None:
            seen = sum(1 for n, _, _ in traced_obs.trace.ops
                       if "fused_chain_kernel" in n or "kron_axis_kernel" in n)
            log(f"[trace] profiler recorded {seen} of {launches} kernel launches"
                f" of the window; {n_quiet} requests before it, "
                f"{len(traced)} under it")
    else:
        obs = traced_obs = observe(records, spans, (w0, w1))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module("metrics", m["name"], root).read(
            obs if m["source"] == "host_clock" else traced_obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup"] = {**setup, "first_in_checkout": first_in_checkout}
    # JSON has no infinity: a gap with no finite value reads as 1e300
    result["checks"] = {n: {"value": gaps[n] if math.isfinite(gaps[n]) else 1e300,
                            "limit": limits[n]} for n in gaps}

    log(f"[run] {cell.name} seed {seed}: {len(ok)} requests ok, "
        f"{len(failed)} failed, window {w1 - w0:.3f} s, set-up {setup_s:.3f} s "
        f"({'first in checkout, ' if first_in_checkout else ''}"
        + ", ".join(f"{k} {v:.3f}" for k, v in setup.items())
        + f"), check {check_s:.3f} s, launches {launches}")
    lines = [f"check {n} {gaps[n]!r} limit {limits[n]!r}"
             + ("" if gaps[n] <= limits[n] else " FAILED") for n in gaps]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment(ROOT)
    import torch

    from rpbench.harness import spec
    cell = spec.load_cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"rpbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"rpbench: loaded in the run: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
