"""MarginalEngine: a plan's kernel chains planned once, served many times.

At construction the engine walks the plan's signature groups, plans every
kernel chain it will ever need — the measurement chains ⊗ Sub_{n_i} over the
closure and the reconstruction chains ⊗ T_i over the workload — with the
autotuner's launch config (reconstruction chains may take narrow operands,
measurement chains never do), and, on CUDA, launches each once on zeros so
the kernels are built and loaded before the first request.

Usage::

    engine = MarginalEngine(plan)                 # device="cuda" by default
    gen = torch.Generator(device="cuda").manual_seed(0)
    tables, meas = engine.release(marginals, gen)
    nonneg, meas = engine.release(marginals, gen, postprocess="nonneg")
    records = engine.synthesize(100_000, gen)
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.domain import Clique
from repro_torch.core.mechanism import (Measurement, measure, noise_dtype,
                                        signature_groups)
from repro_torch.core.reconstruct import reconstruct_all_batched, u_chain_factors
from repro_torch.core.residual import sub_matrix
from repro_torch.core.select import Plan
from repro_torch.kernels.autotune.tuner import (TunedConfig, autotune_mode,
                                               resolve_config, tune_chain)
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.kernels.kron_matvec.fused import (config_launch, factor_shapes,
                                                   fused_chain_matvec)
from repro_torch.obs import REGISTRY, TRACER, AtomicCounter
from repro_torch.obs.naming import chain_label
from repro_torch.release import (POSTPROCESS_MODES, postprocess_release,
                                 synthesize_records)
from repro_torch.roofline.cost_model import CostModel, detect_device


# Process-wide aggregate of every EngineStats bump, labeled by counter name —
# the /metrics view of engine activity across all engines in the process
# (per-engine values stay on each EngineStats instance).
_ENGINE_EVENTS = REGISTRY.counter(
    "repro_engine_events_total",
    "Engine counter bumps aggregated across all engines", labels=("counter",))


class EngineStats:
    """Per-engine counters, backed by the obs metrics registry.

    Each field is an :class:`~repro_torch.obs.AtomicCounter`; field access
    reads (``stats.measure_calls``) and level-sets
    (``stats.measure_signatures = n``) like a plain attribute, and
    :meth:`bump` increments atomically and mirrors the event into the global
    ``repro_engine_events_total{counter=...}`` family for ``/metrics``.

    * measure/reconstruct_calls, measure/reconstruct_signatures
    * fused_chains / fallback_chains — chain planning outcome
    * tuned_chains — chains registered under a tuned launch config
    * compile_warmups — warmup launches at construction
    * device_h_groups / exact_h_groups / host_y_groups — DiscreteEngine
      exactness tiers (H on the device chain / on the exact host tiers; Y†
      on the float64 host fallback)
    * postprocess_calls / synthesize_calls — releases postprocessed by
      :mod:`repro_torch.release`, and synthesize calls
    * cache_hits / cache_misses — provenance from the engine cache
      (:mod:`repro_torch.engine.sharded`)
    """

    _FIELDS = ("measure_calls", "reconstruct_calls",
               "measure_signatures", "reconstruct_signatures",
               "fused_chains", "fallback_chains", "compile_warmups",
               "tuned_chains", "device_h_groups", "exact_h_groups",
               "host_y_groups", "postprocess_calls", "synthesize_calls",
               "cache_hits", "cache_misses")

    __slots__ = ("_cells",)

    def __init__(self, **initial):
        self._cells = {f: AtomicCounter(int(initial.pop(f, 0)))
                       for f in self._FIELDS}
        if initial:
            raise TypeError(f"unknown EngineStats fields: {tuple(initial)}")

    def bump(self, name: str, n: int = 1) -> None:
        """Atomically increment ``name`` and mirror it to /metrics."""
        self._cells[name].inc(n)
        _ENGINE_MIRRORED[name].inc(n)

    def to_dict(self) -> Dict[str, int]:
        return {f: int(self._cells[f].value) for f in self._FIELDS}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v}" for k, v in self.to_dict().items())
        return f"EngineStats({body})"

    def __eq__(self, other) -> bool:
        if isinstance(other, EngineStats):
            return self.to_dict() == other.to_dict()
        return NotImplemented


def _stats_field(name: str) -> property:
    def _get(self) -> int:
        return int(self._cells[name].value)

    def _set(self, v: int) -> None:
        self._cells[name].set(v)

    return property(_get, _set)


for _f in EngineStats._FIELDS:
    setattr(EngineStats, _f, _stats_field(_f))
del _f

# The family's child per counter, resolved once (a bump is on the hot path).
_ENGINE_MIRRORED = {f: _ENGINE_EVENTS.labels(counter=f)
                    for f in EngineStats._FIELDS}


class ChainRegistry:
    """Chain-plan bookkeeping: one plan per (dims, signature, role) chain.

    Subclasses provide ``self.stats`` (EngineStats) and ``self.device``;
    ``self._chain_plans`` maps each chain to a ``(ChainPlan, factors,
    batch)`` tuple, the plan carrying the chain's epilogue and operand type.

    Registration is where the autotuner hooks in: unless
    ``REPRO_KERNEL_AUTOTUNE`` is ``off``, every chain is tuned up front (in
    ``measure`` mode by timing kernels, outside any request, and persisted;
    in ``model`` mode resolved as a serving call resolves it), and the plan
    is the launch the serving path will make.  ``role`` is the chain's
    duty: ``"measure"`` chains carry Gaussian noise and are planned at
    float32; ``"reconstruct"`` chains may take a tuned narrow operand type
    (float32 accumulation).  Each new chain publishes its cost model
    predictions as gauges (:meth:`_publish_roofline`).
    """

    _chain_plans: Dict[tuple, tuple]
    _chain_tune: Dict[tuple, Optional[TunedConfig]]
    _chain_roles: Dict[tuple, str]

    def _register_chain(self, factors: List, dims: Tuple[int, ...],
                        batch: int,
                        epilogue: Optional[Sequence[Optional[str]]] = None,
                        role: str = "measure") -> None:
        if role not in ("measure", "reconstruct"):
            raise ValueError(f"unknown chain role {role!r}")
        mode = autotune_mode()
        cfg = None
        if mode == "measure":
            cfg = tune_chain(factors, dims, batch=batch, epilogue=epilogue,
                             device=self.device, mode="measure")
        elif mode == "model":
            cfg = resolve_config(factors, dims, batch, epilogue, self.device)
        cp, fused = config_launch(factor_shapes(factors, dims), dims, batch,
                                  epilogue, cfg, role == "reconstruct")
        key = (tuple(dims), cp.signature, role)
        if key not in self._chain_plans:
            if not hasattr(self, "_chain_tune"):
                self._chain_tune, self._chain_roles = {}, {}
            self._chain_plans[key] = (cp, factors, batch)
            self._chain_tune[key] = cfg
            self._chain_roles[key] = role
            self.stats.bump("fused_chains" if fused else "fallback_chains")
            if cfg is not None:
                self.stats.bump("tuned_chains")
            self._publish_roofline(key, cp, batch)

    def _publish_roofline(self, key: tuple, cp, batch: int) -> None:
        """Export the chain's cost model predictions as gauges.

        Predicted arithmetic intensity, shared-memory footprint and runtime
        (:mod:`repro_torch.roofline.cost_model`, the row of the engine's
        device) sit next to the measured ``repro_kernel_launch_seconds``
        histogram under the same ``chain`` label.  The JAX package's VMEM
        gauge (``repro_chain_vmem_bytes``) becomes the planned shared-memory
        bytes of one block, ``repro_chain_smem_bytes``.
        """
        try:
            cost = CostModel(detect_device(self.device)).chain_cost(cp, batch)
        except Exception:   # the cost model is advisory; never fail planning
            return
        label = chain_label(key[0], batch, cp.compute_dtype)
        REGISTRY.gauge(
            "repro_chain_predicted_intensity",
            "Roofline-predicted arithmetic intensity (FLOP/byte)",
            labels=("chain",)).labels(chain=label).set(cost.intensity)
        REGISTRY.gauge(
            "repro_chain_smem_bytes",
            "Planned shared-memory bytes per block of the fused chain kernel",
            labels=("chain",)).labels(chain=label).set(cp.smem_bytes)
        REGISTRY.gauge(
            "repro_chain_predicted_seconds",
            "Roofline-predicted single-launch runtime",
            labels=("chain",)).labels(chain=label).set(cost.predicted_s)

    def _chain_allow_narrow(self, key: tuple) -> bool:
        """Reconstruct-role chains may serve at a tuned narrow dtype."""
        return getattr(self, "_chain_roles", {}).get(key) == "reconstruct"

    def _warmup(self) -> None:
        """Run every planned chain, epilogue included, once on zeros: builds
        and loads the kernels and touches every launch shape the serving
        path will use."""
        for key, (cp, factors, batch) in self._chain_plans.items():
            x = torch.zeros((batch, cp.n_in), dtype=torch.float32,
                            device=self.device)
            fused_chain_matvec(factors, x, key[0], epilogue=cp.epilogue,
                               allow_narrow=self._chain_allow_narrow(key))
            self.stats.bump("compile_warmups")
        torch.cuda.synchronize(self.device)

    def chain_plans(self) -> List[dict]:
        """Layout report: one row per planned chain (for ops/debugging)."""
        tune = getattr(self, "_chain_tune", {})
        roles = getattr(self, "_chain_roles", {})
        rows = []
        for key, (cp, _f, batch) in self._chain_plans.items():
            cfg = tune.get(key)
            rows.append(dict(
                dims=key[0], batch=batch, rows=cp.rows, buf=cp.buf,
                smem_bytes=cp.smem_bytes,
                fused=(cfg.fused and cp.fused_ok) if cfg else cp.fused_ok,
                epilogue=cp.epilogue, compute_dtype=cp.compute_dtype,
                role=roles.get(key), tuned=cfg is not None,
                tune_source=cfg.source if cfg else "default",
                intensity=cfg.intensity if cfg else None))
        return rows


class ReleaseServing:
    """release/postprocess/synthesize surface shared by all serving engines.

    ``release(..., postprocess="consistent"|"nonneg")`` routes the raw
    reconstruction through :mod:`repro_torch.release`: covariance-weighted
    consistency (precision weights straight off the plan's IR, the CG's
    chains on the engine's device and kernels) and, for ``"nonneg"``, the
    signature-batched simplex projection with exact total preservation.
    ``synthesize`` samples records from the last non-negative release (or
    explicit ``tables``).  Engines override ``_postprocess_total`` (the
    secure path pins the measured integer total) and ``_check_postprocess``
    (RP+ restricts to identity-basis schemas).
    """

    _synth_tables: Optional[Dict[Clique, np.ndarray]] = None

    def _postprocess_total(self, measurements) -> Optional[float]:
        """Total-count pin for the consistency fit (None: fit it)."""

    def _check_postprocess(self) -> None:
        """Raise when this plan family's tables are not plain marginals."""

    def release(self, marginals, gen: torch.Generator,
                postprocess: Optional[str] = None,
                total: Optional[float] = None, weights=None,
                mw_rounds: int = 0, **post_opts):
        """measure → reconstruct (→ postprocess); returns (tables, meas).

        ``postprocess=None`` is the raw unbiased release; ``"consistent"`` /
        ``"nonneg"`` run the release subsystem with ``total``/``weights``/
        ``mw_rounds`` (and ``post_opts``: ``backend``, ``tol``, ``maxiter``)
        forwarded to :func:`repro_torch.release.postprocess_release`, on the
        engine's device and with its ``use_kernel``.  The plan family and
        the mode are checked before anything is measured.
        """
        if postprocess is not None:
            self._check_postprocess()
            if postprocess not in POSTPROCESS_MODES:
                raise ValueError(f"postprocess mode must be one of "
                                 f"{POSTPROCESS_MODES}, got {postprocess!r}")
        meas = self.measure(marginals, gen)
        tables = self.reconstruct(meas)
        if postprocess is not None:
            if total is None:
                total = self._postprocess_total(meas)
            tables = postprocess_release(
                self.plan, tables, postprocess, total=total, weights=weights,
                mw_rounds=mw_rounds, device=self.device,
                use_kernel=self.use_kernel, **post_opts)
            self.stats.bump("postprocess_calls")
            if postprocess == "nonneg":
                self._synth_tables = tables
        return tables, meas

    def synthesize(self, n_records: int, gen: torch.Generator, tables=None,
                   order=None, batch: Optional[int] = None) -> np.ndarray:
        """Sample (n_records, n_attrs) int32 synthetic records.

        ``tables=None`` uses the engine's last ``postprocess="nonneg"``
        release; ``gen`` is a ``torch.Generator`` on the engine's device.
        Junction-order conditional sampling is vectorized over the records
        (:func:`repro_torch.release.synthesize_records`) and never touches
        the contingency table.
        """
        if tables is None:
            tables = self._synth_tables
            if tables is None:
                raise ValueError(
                    "no non-negative release to sample from: call "
                    "release(..., postprocess=\"nonneg\") first or pass "
                    "tables=")
        self.stats.bump("synthesize_calls")
        return synthesize_records(self.plan.domain, tables, n_records, gen,
                                  order=order, batch=batch, device=self.device)


class MarginalEngine(ReleaseServing, ChainRegistry):
    """Plan a plan's kernel chains once; serve measure/reconstruct traffic.

    Parameters
    ----------
    plan:        selection-phase output (σ²_A per closure clique).
    use_kernel:  route chains through the hand-written kernels (default) or
                 the plain batched torch path.
    precompile:  on CUDA, launch every chain once at construction so the
                 kernels are built and loaded before serving.
    dtype:       noise dtype; ``None`` is float32.
    device:      ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.
    """

    def __init__(self, plan: Plan, use_kernel: Optional[bool] = None,
                 precompile: bool = True, dtype=None, device=None):
        self.plan = plan
        self.device = resolve_device(device)
        self.use_kernel = True if use_kernel is None else use_kernel
        self.dtype = noise_dtype() if dtype is None else dtype
        self.stats = EngineStats()
        self._measure_groups = signature_groups(plan.domain, plan.cliques)
        self._reconstruct_groups = signature_groups(plan.domain,
                                                    plan.workload.cliques)
        self.stats.measure_signatures = len(self._measure_groups)
        self.stats.reconstruct_signatures = len(self._reconstruct_groups)
        self._chain_plans: Dict[tuple, tuple] = {}
        for dims, cliques in self._measure_groups.items():
            if dims:
                self._register_chain([sub_matrix(n) for n in dims], dims,
                                     2 * len(cliques), role="measure")
        for dims, cliques in self._reconstruct_groups.items():
            if dims:
                self._register_chain(u_chain_factors(plan.domain, cliques[0]),
                                     dims, len(cliques), role="reconstruct")
        if precompile and self.use_kernel and self.device.type == "cuda":
            self._warmup()

    # ------------------------------------------------------------------ serve
    def measure(self, marginals: Mapping[Clique, np.ndarray],
                gen: torch.Generator) -> Dict[Clique, Measurement]:
        """Algorithm 1 over the whole closure: one chain per signature."""
        self.stats.bump("measure_calls")
        with TRACER.span("engine.measure").set(
                engine="marginal", cliques=len(self.plan.cliques),
                use_kernel=self.use_kernel):
            return measure(self.plan, marginals, gen,
                           use_kernel=self.use_kernel, batched=True,
                           dtype=self.dtype, device=self.device)

    def reconstruct(self, measurements: Mapping[Clique, Measurement],
                    cliques: Optional[Sequence[Clique]] = None
                    ) -> Dict[Clique, np.ndarray]:
        """Algorithm 2 for the workload (or ``cliques``): batched merged chains."""
        self.stats.bump("reconstruct_calls")
        with TRACER.span("engine.reconstruct").set(
                engine="marginal", use_kernel=self.use_kernel):
            return reconstruct_all_batched(self.plan, measurements, cliques,
                                           use_kernel=self.use_kernel,
                                           device=self.device)

    # ------------------------------------------------------------- introspect
    def variances(self) -> Dict[Clique, float]:
        return self.plan.workload_variances()
