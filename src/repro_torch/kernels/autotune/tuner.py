"""Per-chain launch-config autotuner for the fused Kronecker-chain kernel.

The port of the JAX package's ``repro/kernels/autotune/tuner.py``.  For each
chain group (factor shapes, epilogue, batch) it enumerates a lattice of
``(rows, compute_dtype)`` launch configs, scores each with the analytic cost
model (:class:`repro_torch.roofline.CostModel`, the row of the device the
call runs on), compares the best fused candidate with the modelled per-axis
route, and keeps the winner.  ``REPRO_KERNEL_AUTOTUNE`` selects the mode:

* ``off``     — the untuned plan everywhere;
* ``model``   — the analytic pick only (the default; launches nothing);
* ``measure`` — the analytic top 3 timed for real (CUDA events on the card,
  the host clock on the CPU) after one warm call each, beside the per-axis
  route; a candidate whose launch fails raises.

Winners live in a per-process registry and, when tuned through
:func:`tune_chain` / :func:`pretune`, in the on-disk cache (cache.py) keyed
by device and chain, so a restart skips re-tuning.  A miss inside a kernel
call (:func:`resolve_config`) tunes with the model only and does not persist.

Narrow candidates (bf16/fp16 operands, float32 accumulation) are scored only
when ``REPRO_KERNEL_COMPUTE_DTYPES`` lists them or a caller asks; call sites
that carry Gaussian noise serve a narrow config at float32
(``allow_narrow=False`` in ``fused_chain_matvec``).  The dtypes offered are
part of the chain key, so changing the variable never serves a config tuned
over another set.
"""
from __future__ import annotations

import math
import os
import threading
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.kernels.kron_matvec.fused import (dtype_name, factor_shapes,
                                                   fit_rows, plan_shapes)
from repro_torch.roofline.cost_model import CostModel, DeviceSpec, detect_device

from .cache import TuningCache

# The per-axis route must beat the best fused candidate by this margin: a
# near tie keeps the one-launch fused path.
_FALLBACK_MARGIN = 0.9

# measure mode: how many of the model's best candidates to time, and how
# many timed calls each (the least counts).
_MEASURE_TOP_K = 3
_MEASURE_REPS = 3


@dataclass(frozen=True)
class TunedConfig:
    """The winner for one chain group: what the kernel launches with."""

    rows: int                        # batch rows per block
    smem_budget: int                 # the planned shared memory, bytes
    compute_dtype: str = "float32"
    fused: bool = True               # False: the per-axis route is faster
    predicted_s: float = 0.0         # model seconds (measure: timed seconds)
    intensity: float = 0.0           # model FLOP per device-memory byte
    blocks: int = 0                  # blocks of the launch
    source: str = "model"            # model | measure | cache

    def as_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TunedConfig":
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})


def autotune_mode() -> str:
    m = os.environ.get("REPRO_KERNEL_AUTOTUNE", "model").strip().lower()
    return m if m in ("off", "model", "measure") else "model"


def _dtype_candidates(dtypes: Optional[Sequence[str]]) -> Tuple[str, ...]:
    if not dtypes:
        env = os.environ.get("REPRO_KERNEL_COMPUTE_DTYPES", "")
        dtypes = [d.strip() for d in env.split(",") if d.strip()]
    return tuple(dtype_name(d) for d in dtypes) or ("float32",)


def chain_key(device_kind: str, dims: Sequence[int],
              fshapes: Sequence[Optional[Tuple[int, int]]],
              epilogue: Optional[Sequence[Optional[str]]],
              batch: int, dtypes: Sequence[str] = ("float32",)) -> str:
    """Stable string key of one (device, chain, batch, dtypes offered) group."""
    f = ",".join("-" if s is None else f"{s[0]}x{s[1]}" for s in fshapes)
    e = ",".join("-" if op is None else str(op)
                 for op in (epilogue or (None,) * len(tuple(dims))))
    d = ",".join(str(int(n)) for n in dims)
    c = ",".join(dtypes)
    return f"{device_kind}|d={d}|f={f}|e={e}|b={int(batch)}|c={c}"


# Per-process registry: chain_key -> TunedConfig, the decisions in effect.
# A server's worker inserts keys (the key holds the exact batch) while its
# HTTP thread snapshots them for /stats, so writes and the snapshot's copy
# hold one lock; a lookup is one dict read and takes none.
_REGISTRY: Dict[str, TunedConfig] = {}      # guarded-by: _REGISTRY_LOCK
_REGISTRY_LOCK = threading.Lock()


def _register(key: str, cfg: TunedConfig) -> None:
    with _REGISTRY_LOCK:
        _REGISTRY[key] = cfg


def reset_registry() -> None:
    with _REGISTRY_LOCK:
        _REGISTRY.clear()


def registry_snapshot(device=None) -> dict:
    with _REGISTRY_LOCK:
        entries = list(_REGISTRY.items())
    return {"mode": autotune_mode(), "device": detect_device(device).kind,
            "entries": {k: cfg.as_dict() for k, cfg in entries}}


def _rows_lattice(batch: int, fit: int, default: int) -> List[int]:
    """Powers of two up to what fits (and up to the batch), that bound
    itself, and plan_chain's default."""
    top = min(fit, max(int(batch), 1))
    cands = {default, top}
    r = 1
    while r < top:
        cands.add(r)
        r *= 2
    return sorted(c for c in cands if 1 <= c <= fit)


def _score(fshapes, dims, batch, epi, dtypes, model: CostModel):
    """[(cost, plan)] of every fused candidate that fits, best first."""
    scored = []
    for dt in dtypes:
        base = plan_shapes(fshapes, dims, batch, model.device.smem_limit, epi,
                           None, dt)
        fit = fit_rows(base.nf, base.buf, dt, model.device.smem_limit)
        for r in _rows_lattice(batch, fit, base.rows):
            plan = plan_shapes(fshapes, dims, batch, model.device.smem_limit,
                               epi, r, dt)
            if plan.fused_ok:
                scored.append((model.chain_cost(plan, batch), plan))
    scored.sort(key=lambda cp: cp[0].predicted_s)
    return scored


def _tune(fshapes, dims, batch, epi, dtypes, spec: DeviceSpec, mode: str,
          factors=None, device=None) -> TunedConfig:
    model = CostModel(spec)
    scored = _score(fshapes, dims, batch, epi, dtypes, model)
    per_axis_s = model.per_axis_cost(dims, fshapes, batch, epi)
    source = "measure" if mode == "measure" else "model"
    if not scored:
        return TunedConfig(rows=1, smem_budget=spec.smem_limit,
                           fused=False, predicted_s=per_axis_s, source=source)
    best_cost, best_plan = scored[0]
    best_s = best_cost.predicted_s
    if mode == "measure":
        best_s, best_plan, per_axis_s = _refine_by_timing(
            scored[:_MEASURE_TOP_K], factors, dims, batch, epi, device,
            per_axis_s)
        best_cost = next(c for c, p in scored if p == best_plan)
    # On a plain device (the CPU) both routes run the same plain code, so
    # the route is not a speed choice there: what fits stays fused.
    fused = spec.plain or not per_axis_s < _FALLBACK_MARGIN * best_s
    return TunedConfig(rows=best_plan.rows, smem_budget=best_plan.smem_bytes,
                       compute_dtype=best_plan.compute_dtype, fused=fused,
                       predicted_s=best_s if fused else per_axis_s,
                       intensity=best_cost.intensity, blocks=best_cost.blocks,
                       source=source)


def tune_chain(factors: Sequence, dims: Sequence[int], batch: int = 1,
               epilogue: Optional[Sequence[Optional[str]]] = None,
               dtypes: Optional[Sequence[str]] = None,
               device=None, spec: Optional[DeviceSpec] = None,
               mode: Optional[str] = None,
               persist: bool = True) -> TunedConfig:
    """Tune ONE chain group, register the winner and (``persist``) cache it.

    ``device`` is where the chain runs (CUDA unless ``device="cpu"``; with
    no card and no device it raises, as every entry point does); ``spec``
    overrides its cost-model row.  ``dtypes`` widens the candidates
    beyond float32 (default: ``REPRO_KERNEL_COMPUTE_DTYPES``).  ``mode``
    overrides the environment's: ``"measure"`` times candidates on
    ``device``.
    """
    dev = resolve_device(device)
    spec = detect_device(dev) if spec is None else spec
    mode = autotune_mode() if mode is None else mode
    dims = tuple(int(d) for d in dims)
    fshapes = factor_shapes(factors, dims)
    epi = tuple(epilogue) if epilogue is not None else (None,) * len(dims)
    cands = _dtype_candidates(dtypes)
    cfg = _tune(fshapes, dims, batch, epi, cands, spec, mode, factors, dev)
    key = chain_key(spec.kind, dims, fshapes, epi, batch, cands)
    _register(key, cfg)
    if persist:
        TuningCache(spec.kind).put(key, cfg.as_dict())
    return cfg


def _refine_by_timing(shortlist, factors, dims, batch, epilogue, device,
                      per_axis_s):
    """Time the model's best candidates and the per-axis route on
    ``device``; returns (best fused seconds, its plan, per-axis seconds).

    Every call passes its config explicitly, which bypasses the tuner in
    ``fused_chain_matvec``: no recursion, and the time is that of exactly
    the launch being scored.  A failed launch raises.
    """
    from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec
    x = torch.zeros((max(batch, 1), math.prod(dims)), device=device)
    best = None
    for _cost, plan in shortlist:
        t = _timed(lambda plan=plan: fused_chain_matvec(
            factors, x, dims, rows=plan.rows, smem_budget=plan.smem_bytes,
            epilogue=epilogue, compute_dtype=plan.compute_dtype), device)
        if best is None or t < best[0]:
            best = (t, plan)
    if math.isfinite(per_axis_s):
        per_axis_s = _timed(lambda: fused_chain_matvec(
            factors, x, dims, smem_budget=0, epilogue=epilogue), device)
    return best[0], best[1], per_axis_s


def _timed(fn, device) -> float:
    """Least seconds of ``_MEASURE_REPS`` calls of ``fn`` after one warm
    call: CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        best = math.inf
        for _ in range(_MEASURE_REPS):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best
    torch.cuda.synchronize(device)
    best = math.inf
    for _ in range(_MEASURE_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def resolve_shapes(fshapes, dims: Sequence[int], batch: int,
                   epilogue: Optional[Sequence[Optional[str]]] = None,
                   device=None) -> Optional[TunedConfig]:
    """:func:`resolve_config` from the factors' shapes (the wrapper's path)."""
    if autotune_mode() == "off":
        return None
    spec = detect_device(device)
    dims = tuple(int(d) for d in dims)
    epi = tuple(epilogue) if epilogue is not None else (None,) * len(dims)
    cands = _dtype_candidates(None)
    key = chain_key(spec.kind, dims, fshapes, epi, batch, cands)
    cfg = _REGISTRY.get(key)
    if cfg is not None:
        return cfg
    blob = TuningCache(spec.kind).get(key)
    if blob is not None:
        cfg = TunedConfig.from_dict({**blob, "source": "cache"})
    else:
        cfg = _tune(fshapes, dims, batch, epi, cands, spec, "model")
    _register(key, cfg)
    return cfg


def resolve_config(factors: Sequence, dims: Sequence[int], batch: int,
                   epilogue: Optional[Sequence[Optional[str]]] = None,
                   device=None) -> Optional[TunedConfig]:
    """The tuned config of a chain call, or None when tuning is off.

    Resolution order: the mode gate, the per-process registry, the on-disk
    cache, then an analytic tune that is registered but not persisted.
    ``fused_chain_matvec`` calls it when the caller passed no launch config.
    """
    return resolve_shapes(factor_shapes(factors, dims), dims, batch,
                          epilogue, device)


def pretune(chains: Sequence[tuple], device=None, mode: Optional[str] = None,
            dtypes: Optional[Sequence[str]] = None) -> List[TunedConfig]:
    """Tune chain groups up front and persist the winners.

    ``chains`` holds ``(factors, dims, batch, epilogue)`` tuples; in
    ``measure`` mode this is where kernels are timed, outside any request.
    ``device`` as in :func:`tune_chain`: CUDA unless ``device="cpu"``.
    """
    device = resolve_device(device)
    return [tune_chain(factors, dims, batch=batch, epilogue=epilogue,
                       dtypes=dtypes, device=device, mode=mode, persist=True)
            for factors, dims, batch, epilogue in chains]


__all__ = ["TunedConfig", "autotune_mode", "chain_key", "pretune",
           "registry_snapshot", "reset_registry", "resolve_config",
           "resolve_shapes", "tune_chain"]
