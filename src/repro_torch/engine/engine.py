"""MarginalEngine: a plan's kernel chains planned once, served many times.

At construction the engine walks the plan's signature groups, plans every
kernel chain it will ever need — the measurement chains ⊗ Sub_{n_i} over the
closure and the reconstruction chains ⊗ T_i over the workload — and, on
CUDA, launches each once on zeros so the kernels are built and loaded before
the first request.

Usage::

    engine = MarginalEngine(plan)                 # device="cuda" by default
    gen = torch.Generator(device="cuda").manual_seed(0)
    tables, meas = engine.release(marginals, gen)
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
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec, plan_chain


class EngineStats:
    """Per-engine counters (plain integers).

    * measure/reconstruct_calls, measure/reconstruct_signatures
    * fused_chains / fallback_chains — chain planning outcome
    * compile_warmups — warmup launches at construction
    """

    _FIELDS = ("measure_calls", "reconstruct_calls",
               "measure_signatures", "reconstruct_signatures",
               "fused_chains", "fallback_chains", "compile_warmups")

    __slots__ = _FIELDS

    def __init__(self, **initial):
        for f in self._FIELDS:
            setattr(self, f, int(initial.pop(f, 0)))
        if initial:
            raise TypeError(f"unknown EngineStats fields: {tuple(initial)}")

    def bump(self, name: str, n: int = 1) -> None:
        setattr(self, name, getattr(self, name) + n)

    def to_dict(self) -> Dict[str, int]:
        return {f: getattr(self, f) for f in self._FIELDS}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v}" for k, v in self.to_dict().items())
        return f"EngineStats({body})"


class ChainRegistry:
    """Chain-plan bookkeeping: one plan per (dims, signature) chain.

    Subclasses provide ``self.stats`` (EngineStats) and their own warmup
    loops over ``self._chain_plans``, whose values are
    ``(ChainPlan, factors, batch)`` tuples.  The JAX package's autotuner and
    roofline hooks are not ported yet.
    """

    _chain_plans: Dict[tuple, tuple]

    def _register_chain(self, factors: List, dims: Tuple[int, ...],
                        batch: int) -> None:
        cp = plan_chain(factors, dims, batch=batch)
        key = (tuple(dims), cp.signature)
        if key not in self._chain_plans:
            self._chain_plans[key] = (cp, factors, batch)
            self.stats.bump("fused_chains" if cp.fused_ok else "fallback_chains")

    def chain_plans(self) -> List[dict]:
        """Layout report: one row per planned chain (for ops/debugging)."""
        return [dict(dims=key[0], batch=batch, rows=cp.rows, buf=cp.buf,
                     smem_bytes=cp.smem_bytes, fused=cp.fused_ok)
                for key, (cp, _f, batch) in self._chain_plans.items()]


class ReleaseServing:
    """The release surface of a serving engine."""

    def release(self, marginals, gen: torch.Generator,
                postprocess: Optional[str] = None):
        """measure → reconstruct; returns (tables, meas).

        ``postprocess=None`` is the raw unbiased release.  The JAX package's
        ``"consistent"`` / ``"nonneg"`` postprocessing is not ported yet.
        """
        if postprocess is not None:
            raise NotImplementedError("release postprocessing is not ported "
                                      "yet (ROADMAP queue 1, item 11)")
        meas = self.measure(marginals, gen)
        return self.reconstruct(meas), meas


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
                                     2 * len(cliques))
        for dims, cliques in self._reconstruct_groups.items():
            if dims:
                self._register_chain(u_chain_factors(plan.domain, cliques[0]),
                                     dims, len(cliques))
        if precompile and self.use_kernel and self.device.type == "cuda":
            self._warmup()

    def _warmup(self) -> None:
        """Run every planned chain once on zeros: builds and loads the
        kernels and touches every launch shape the serving path will use."""
        for key, (cp, factors, batch) in self._chain_plans.items():
            x = torch.zeros((batch, cp.n_in), dtype=torch.float32,
                            device=self.device)
            fused_chain_matvec(factors, x, key[0])
            self.stats.bump("compile_warmups")
        torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ serve
    def measure(self, marginals: Mapping[Clique, np.ndarray],
                gen: torch.Generator) -> Dict[Clique, Measurement]:
        """Algorithm 1 over the whole closure: one chain per signature."""
        self.stats.bump("measure_calls")
        return measure(self.plan, marginals, gen, use_kernel=self.use_kernel,
                       batched=True, dtype=self.dtype, device=self.device)

    def reconstruct(self, measurements: Mapping[Clique, Measurement],
                    cliques: Optional[Sequence[Clique]] = None
                    ) -> Dict[Clique, np.ndarray]:
        """Algorithm 2 for the workload (or ``cliques``): batched merged chains."""
        self.stats.bump("reconstruct_calls")
        return reconstruct_all_batched(self.plan, measurements, cliques,
                                       use_kernel=self.use_kernel,
                                       device=self.device)

    # ------------------------------------------------------------- introspect
    def variances(self) -> Dict[Clique, float]:
        return self.plan.workload_variances()
