r"""DiscreteEngine: the secure release path on the kernel chains (Alg 3).

``measure_discrete`` (core/discrete.py) is the host-exact reference: per
clique, ``kron_matvec_np`` for H = ⊗(n_i·I − 11ᵀ) and Y† = ⊗ Sub†/n_i around
a serial noise draw.  This engine serves the same mechanism with

* **signature-batched device transforms** — cliques with equal attribute-size
  signatures stack into the batch axis of ONE chain per group for both H
  (forward) and Y† (back to residual coordinates), on the hand-written
  kernels like :class:`~repro_torch.engine.engine.MarginalEngine`'s chains.
  No per-clique ``kron_matvec_np`` remains on the hot path (test-enforced);
* **host-exact noise only** — the discrete Gaussian draw runs through the
  batched integer-lane sampler (:mod:`repro_torch.core.dgauss`), pooled
  across the cliques of a group that share γ².  Exactness of the *noise* is
  what the privacy proof needs; it never leaves the host;
* **an explicit exactness boundary for H** — Ξx = Hv must be released as
  exact integers.  The engine bounds every intermediate of the chain from
  the actual tables (see :meth:`DiscreteEngine._h_transform`) and routes a
  group to the device chain + ``rint`` only while all of them are exactly
  representable in the chain's float type; beyond that the group takes an
  *exact integer* batched tensordot on the host (int64, then Python big-int
  lanes) — still one transform per group, never per clique.  Y† is
  post-processing (Thm 6): device floats are acceptable there, with a
  float64 host fallback only where huge-γ² lanes would overflow float32.

H and Y† carry the mechanism's integers and noise: they are registered as
``"measure"`` chains, which the tuner plans at float32 whatever
``REPRO_KERNEL_COMPUTE_DTYPES`` offers.  Only the reconstruction chains
(role ``"reconstruct"``) may take a narrow operand type.

Usage::

    engine = plan.engine(secure=True)        # or DiscreteEngine(plan)
    gen = torch.Generator(device="cuda").manual_seed(0)
    meas = engine.measure(marginals, gen)    # gen: torch.Generator /
    tables = engine.reconstruct(meas)        #      np Generator / random.Random
    tables, meas = engine.release(marginals, gen)
"""
from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dgauss
from repro_torch.core.discrete import (DiscreteMeasurement, clique_gamma2,
                                       discrete_pcost_of_plan, h_factors,
                                       ypinv_factors)
from repro_torch.core.domain import Clique
from repro_torch.core.kron import kron_matvec_batched, kron_matvec_np_batched
from repro_torch.core.mechanism import noise_dtype, signature_groups
from repro_torch.core.plantable import BasePlan
from repro_torch.core.reconstruct import reconstruct_all_batched, u_chain_factors
from repro_torch.engine.engine import ChainRegistry, EngineStats, ReleaseServing
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec
from repro_torch.obs import TRACER
from repro_torch.release import measured_integer_total

# Integers below 2^24 are exact in float32, below 2^53 in float64.
_MANTISSA_BITS = {torch.float32: 24, torch.float64: 53}


def as_np_rng(source) -> np.random.Generator:
    """Normalize a randomness source to the ``np.random.Generator`` the
    host sampler draws from.

    ``np.random.Generator`` and ``random.Random`` go through
    :func:`repro_torch.core.dgauss.as_np_rng`.  A ``torch.Generator`` (the
    engines' convention, ``measure(marginals, gen)``) seeds a
    ``SeedSequence`` from four 32-bit words drawn from it with
    ``torch.randint``: deterministic given the generator's state, which the
    draw advances, so one seeded generator gives the same noise every time.
    """
    if isinstance(source, (np.random.Generator, random.Random)):
        return dgauss.as_np_rng(source)
    if isinstance(source, torch.Generator):
        words = torch.randint(0, 1 << 32, (4,), generator=source,
                              dtype=torch.int64, device=source.device)
        return np.random.default_rng(np.random.SeedSequence(
            words.cpu().tolist()))
    raise TypeError(f"expected torch.Generator, np.random.Generator or "
                    f"random.Random, got {type(source).__name__}")


class DiscreteEngine(ReleaseServing, ChainRegistry):
    """Plan a plan's secure-release chains once; serve Alg 3 traffic.

    Parameters
    ----------
    plan:        selection-phase output over a *plain* (identity-basis) IR —
                 the integer-query rotation does not exist for RP+ bases.
    use_kernel:  route H and Y† through the hand-written kernels (default;
                 float32) or the plain batched torch chain at ``dtype``.
    precompile:  on CUDA, launch every chain once at construction.
    dtype:       the plain chain's type when ``use_kernel=False``; ``None``
                 is float32.  Only the H exactness bound and Y† precision
                 depend on it — the noise is integer-exact regardless.
    digits:      σ̄ rationalization digits (Alg 3 line 1 / §5.2).
    device:      ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.
    """

    def __init__(self, plan: BasePlan, use_kernel: Optional[bool] = None,
                 precompile: bool = True, dtype=None, digits: int = 4,
                 device=None):
        if not getattr(plan.table, "plain", True):
            raise ValueError("DiscreteEngine requires a plain (identity-basis)"
                             " plan; RP+ plans have no integer-query rotation")
        self.plan = plan
        self.digits = digits
        self.device = resolve_device(device)
        self.use_kernel = True if use_kernel is None else use_kernel
        self.dtype = noise_dtype() if dtype is None else dtype
        if self.dtype not in _MANTISSA_BITS:
            raise TypeError(f"chain dtype {self.dtype}: expected float32 or "
                            "float64")
        self.stats = EngineStats()
        # Exact per-clique σ̄/γ² (Alg 3 lines 1-2), computed once.
        self.sigma_bars: Dict[Clique, object] = {}
        self.gamma2s: Dict[Clique, object] = {}
        for c in plan.cliques:
            sb, g2, _ = clique_gamma2(plan, c, digits)
            self.sigma_bars[c] = sb
            self.gamma2s[c] = g2
        self._groups = signature_groups(plan.domain, plan.cliques)
        self._reconstruct_groups = signature_groups(plan.domain,
                                                    plan.workload.cliques)
        self.stats.measure_signatures = len(self._groups)
        self.stats.reconstruct_signatures = len(self._reconstruct_groups)
        self._chain_plans: Dict[tuple, tuple] = {}
        for dims, cliques in self._groups.items():
            if dims:
                self._register_chain(h_factors(dims), dims, len(cliques),
                                     role="measure")
                self._register_chain(ypinv_factors(dims), dims, len(cliques),
                                     role="measure")
        for dims, cliques in self._reconstruct_groups.items():
            if dims:
                self._register_chain(u_chain_factors(plan.domain, cliques[0]),
                                     dims, len(cliques), role="reconstruct")
        if precompile and self.use_kernel and self.device.type == "cuda":
            self._warmup()

    # ------------------------------------------------------------ transforms
    def _device_chain(self, factors: List[np.ndarray], x: np.ndarray,
                      dims: Tuple[int, ...]) -> np.ndarray:
        """One chain over the stacked rows ``x`` on the device; float64 out.

        The kernels run at float32 (``allow_narrow`` stays False: these
        chains carry the mechanism's integers and noise)."""
        if self.use_kernel:
            xt = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
            y = fused_chain_matvec(factors, xt, dims)
        else:
            xt = torch.from_numpy(np.asarray(x)).to(self.device, self.dtype)
            y = kron_matvec_batched(factors, xt, dims)
        return y.cpu().numpy().astype(np.float64)

    def _chain_dtype(self) -> torch.dtype:
        return torch.float32 if self.use_kernel else self.dtype

    def _h_transform(self, vs: np.ndarray, dims: Tuple[int, ...]) -> np.ndarray:
        """Exact Ξx = Hv for a stacked group of marginal tables (counts).

        Device chain + ``rint`` while every intermediate provably stays
        inside the chain type's exact-integer range; exact host int64 /
        big-int batched tensordot beyond (stats-counted).  Every tier returns
        *exact integers* — int64 when they fit, object (Python big-int)
        lanes beyond — so the noise addition downstream is exact too.

        Why the bound makes the float32 kernels exact: H's factors (n−1 on
        the diagonal, −1 elsewhere) and the counts are integers.  Per axis
        ‖(nI − 11ᵀ)u‖₁ ≤ 2n‖u‖₁, so every intermediate tensor has ℓ1 norm at
        most ‖v‖₁·Π 2n_i, and every product and every partial sum inside an
        axis's dot — a sum of any subset of its terms, whatever the
        contraction order or tiling — is at most max n_i times that.  Below
        2^24 each of them is an integer that float32 holds exactly, so every
        ``fmaf`` of the fused and of the per-axis kernel is exact; their zero
        padding only adds ``fmaf(0, 0, acc)``, which leaves ``acc`` as it
        is.  The device result is then the int64 result bit for bit, on
        either route, and ``rint`` changes nothing.
        """
        l1 = float(np.abs(vs).sum(axis=1).max(initial=0.0))
        growth = 1.0
        for n in dims:
            growth *= 2 * n
        bound = l1 * growth * max(dims)
        if bound < float(1 << _MANTISSA_BITS[self._chain_dtype()]):
            self.stats.bump("device_h_groups")
            hv = np.rint(self._device_chain(h_factors(dims), vs, dims))
            return hv.astype(np.int64)
        # Exact host tiers: one batched tensordot chain per group (never per
        # clique), int64 lanes, then Python big-int lanes.
        self.stats.bump("exact_h_groups")
        facs = h_factors(dims, np.int64)
        if bound < float(1 << 62):
            return kron_matvec_np_batched(facs, np.rint(vs).astype(np.int64),
                                          dims)
        obj = np.array([[int(v) for v in row] for row in np.rint(vs)],
                       dtype=object)
        return kron_matvec_np_batched([f.astype(object) for f in facs], obj,
                                      dims)

    def _y_transform(self, noisy: np.ndarray, dims: Tuple[int, ...]
                     ) -> np.ndarray:
        """Y† = ⊗ Sub†/n on the noisy integers — post-processing (Thm 6),
        device floats by design; float64 host fallback only when huge-γ²
        lanes would overflow a float32 chain."""
        if self._chain_dtype() == torch.float32 and \
                float(np.abs(noisy).max(initial=0.0)) >= 3e38:
            self.stats.bump("host_y_groups")
            return kron_matvec_np_batched(ypinv_factors(dims),
                                          np.asarray(noisy, np.float64), dims)
        return self._device_chain(ypinv_factors(dims), noisy, dims)

    # ----------------------------------------------------------------- noise
    def _draw_group(self, cliques: List[Clique], n_prod: int,
                    rng: np.random.Generator) -> Dict[Clique, np.ndarray]:
        """Pooled integer-lane draws: cliques sharing γ² share one batched
        ``dgauss.sample`` call (γ² differs only when σ̄ does)."""
        by_gamma2 = defaultdict(list)
        for c in cliques:
            by_gamma2[self.gamma2s[c]].append(c)
        out: Dict[Clique, np.ndarray] = {}
        for g2, cs in by_gamma2.items():
            z = dgauss.sample(g2, n_prod * len(cs), rng)
            for i, c in enumerate(cs):
                out[c] = z[i * n_prod:(i + 1) * n_prod]
        return out

    # ----------------------------------------------------------------- serve
    def measure(self, marginals: Mapping[Clique, np.ndarray], gen,
                _noise_override=None) -> Dict[Clique, DiscreteMeasurement]:
        """Algorithm 3 over the whole closure: one H chain and one Y† chain
        per signature group, host-exact noise in between.

        ``gen`` is a ``torch.Generator``, an ``np.random.Generator`` or a
        ``random.Random`` (see :func:`as_np_rng`); draws are
        seed-deterministic per source state.
        """
        self.stats.bump("measure_calls")
        with TRACER.span("engine.measure").set(
                engine="discrete", cliques=len(self.plan.cliques),
                use_kernel=self.use_kernel):
            return self._measure_impl(marginals, gen, _noise_override)

    def _measure_impl(self, marginals, gen, _noise_override=None
                      ) -> Dict[Clique, DiscreteMeasurement]:
        rng = as_np_rng(gen)
        out: Dict[Clique, DiscreteMeasurement] = {}
        for dims, cliques in self._groups.items():
            if not dims:
                for c in cliques:
                    v = np.asarray(marginals[c], np.float64).reshape(-1)
                    z = (_noise_override(self.gamma2s[c], 1, rng)
                         if _noise_override is not None
                         else dgauss.sample(self.gamma2s[c], 1, rng))
                    sb = self.sigma_bars[c]
                    out[c] = DiscreteMeasurement(
                        c, v + np.asarray(z, np.float64), float(sb ** 2),
                        sb, self.gamma2s[c])
                continue
            m = int(np.prod(dims))
            g = len(cliques)
            vs = np.empty((g, m), np.float64)
            for i, c in enumerate(cliques):
                v = np.asarray(marginals[c], np.float64).reshape(-1)
                if v.shape[0] != m:
                    raise ValueError(
                        f"marginal for {c} has {v.shape[0]} cells, want {m}")
                vs[i] = v
            hv = self._h_transform(vs, dims)                       # = Ξx, exact
            if _noise_override is not None:
                zs = {c: _noise_override(self.gamma2s[c], m, rng)
                      for c in cliques}
            else:
                zs = self._draw_group(cliques, m, rng)
            # M'(x) = Ξx + z summed in exact integer arithmetic; the single
            # float64 conversion of the sum is post-processing.
            noisy = np.empty((g, m), np.float64)
            for i, c in enumerate(cliques):
                z = np.asarray(zs[c])
                if hv.dtype == object or z.dtype == object:
                    s = hv[i].astype(object) + z.astype(object)
                else:
                    s = hv[i] + z                  # int64, |Ξx| + |z| < 2^63
                noisy[i] = s.astype(np.float64)
            om = self._y_transform(noisy, dims)
            for i, c in enumerate(cliques):
                sb = self.sigma_bars[c]
                out[c] = DiscreteMeasurement(c, om[i], float(sb ** 2),
                                             sb, self.gamma2s[c])
        return out

    def reconstruct(self, measurements: Mapping[Clique, DiscreteMeasurement],
                    cliques: Optional[Sequence[Clique]] = None
                    ) -> Dict[Clique, np.ndarray]:
        """Algorithm 2 on the discrete measurements (drop-in ω): batched
        merged U-chains, shared with the continuous engine."""
        self.stats.bump("reconstruct_calls")
        with TRACER.span("engine.reconstruct").set(
                engine="discrete", use_kernel=self.use_kernel):
            return reconstruct_all_batched(self.plan, measurements, cliques,
                                           use_kernel=self.use_kernel,
                                           device=self.device)

    # release()/synthesize() come from ReleaseServing; the secure path pins
    # the consistency fit to the *measured integer total*, so postprocessed
    # families keep it integer-exactly.
    def _postprocess_total(self, measurements) -> float:
        return measured_integer_total(measurements)

    # ------------------------------------------------------------ accounting
    def rho(self) -> float:
        """Total ρ-zCDP actually spent at the rationalized σ̄ (Thm 6)."""
        return discrete_pcost_of_plan(self.plan, self.digits) / 2.0

    def pcost(self) -> float:
        """pcost (= 2ρ) for :class:`~repro_torch.core.accountant.PrivacyBudget`."""
        return discrete_pcost_of_plan(self.plan, self.digits)
