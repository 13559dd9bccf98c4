r"""Numerically secure measurement with discrete Gaussian noise (Section 5, Alg 3).

The pitfall (Example 2): naively swapping the correlated continuous noise
``N(0, σ²Σ_A)`` for independent discrete Gaussians costs up to 2^k in privacy
for k-way marginals.  The fix rotates the base mechanism into an equivalent
*integer-query, independent-noise* mechanism:

    Y   = ⊗_i |Att_i|·Sub_i^†
    Ξ   = Y R_A              (integer matrix;  Ξx = H v  with
                              H = ⊗_i (n_i·I - 1 1ᵀ)  applied to the marginal v)
    γ²  = (s/t)² · Π n_i²    (σ̄ = s/t ≥ σ_A rounded up to a rational)
    M'(x) = Ξ x + N_Z(0, γ² I)      →  release  Y† M'(x)

M' and M_A(·; σ̄²) are mutual post-processings (Thm 6), so the discrete version
inherits the continuous ρ-zCDP guarantee exactly.

The sampler is the exact rejection sampler of Canonne–Kamath–Steinke (2020) —
no floating point touches the noise path (host-side by design; see
docs/DESIGN.md §10).  Two implementations share the distribution exactly:
the scalar ``fractions.Fraction`` reference below, and the batched
integer-lane sampler in :mod:`repro_torch.core.dgauss` that
``measure_discrete`` and the
:class:`~repro_torch.engine.discrete_engine.DiscreteEngine` draw through.

This module is the *host-exact reference* implementation of Algorithm 3
(per-clique ``kron_matvec_np`` transforms, small problems / tests); the
serving hot path is ``plan.engine(secure=True)`` — signature-batched H/Y†
chains on the hand-written kernels with only the noise draw staying
host-side.  The port's own copy of ``repro.core.discrete`` (host numpy and
``fractions``, unchanged): σ̄ and γ² are Fractions computed from the same
float64 σ², so they equal the JAX package's exactly.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from . import dgauss
from .domain import Clique, Domain
from .kron import kron_matvec_np
from .mechanism import Measurement
from .plantable import BasePlan
from .residual import sub_matrix
from .select import Plan


# ---------------------------------------------------------------------------
# Exact discrete Gaussian sampling (CKS'20)
# ---------------------------------------------------------------------------

def _bernoulli(p: Fraction, rng: "random.Random") -> bool:
    """Exact Bernoulli(p) for rational p via arbitrary-precision integer uniform.

    ``random.Random.randrange`` is used (not numpy) because Fraction
    denominators routinely exceed 2**63 on the exact noise path.
    """
    return rng.randrange(p.denominator) < p.numerator


def _bernoulli_exp(gamma: Fraction, rng: "random.Random") -> bool:
    """Exact Bernoulli(exp(-gamma)) for rational gamma >= 0 (CKS Alg. 1)."""
    if gamma <= 1:
        k = 1
        while _bernoulli(gamma / k, rng):
            k += 1
        return k % 2 == 1
    for _ in range(math.floor(gamma)):
        if not _bernoulli_exp(Fraction(1), rng):
            return False
    return _bernoulli_exp(gamma - math.floor(gamma), rng)


def _sample_dlaplace(t: int, rng: "random.Random") -> int:
    """Exact discrete Laplace with scale t:  P(x) ∝ exp(-|x|/t)  (CKS Alg. 2)."""
    while True:
        u = rng.randrange(t)
        if not _bernoulli_exp(Fraction(u, t), rng):
            continue
        v = 0
        while _bernoulli_exp(Fraction(1), rng):
            v += 1
        x = u + t * v
        if _bernoulli(Fraction(1, 2), rng):  # sign
            if x == 0:
                continue
            return -x
        return x


def sample_discrete_gaussian(sigma2: Fraction, rng: "random.Random") -> int:
    """Exact discrete Gaussian N_Z(0, σ²):  P(x) ∝ exp(-x²/2σ²)  (CKS Alg. 3).

    The proposal scale t = ⌊√σ²⌋ + 1 is computed with pure integer
    ``math.isqrt`` on ``numerator // denominator``: the historical
    ``math.sqrt(float(sigma2))`` raised ``OverflowError`` (or silently lost
    precision) once γ² = σ̄²·Π n_i² left float64 range — exactly the large
    cliques where the secure path is mandatory.
    """
    sigma2 = Fraction(sigma2)
    if sigma2 <= 0:
        raise ValueError("sigma2 must be positive")
    t = math.isqrt(sigma2.numerator // sigma2.denominator) + 1
    while True:
        y = _sample_dlaplace(t, rng)
        num = (Fraction(abs(y)) - sigma2 / t) ** 2
        if _bernoulli_exp(num / (2 * sigma2), rng):
            return y


def sample_discrete_gaussian_vec(sigma2: Fraction, size: int,
                                 rng: "random.Random") -> np.ndarray:
    """Legacy serial draw: one scalar rejection loop per lane (bench baseline).

    The hot paths call :func:`repro_torch.core.dgauss.sample` instead — identical
    distribution, vectorized rejection over integer lanes.
    """
    return np.array([sample_discrete_gaussian(sigma2, rng) for _ in range(size)],
                    dtype=object)


# ---------------------------------------------------------------------------
# Algorithm 3
# ---------------------------------------------------------------------------

def rationalize_sigma(sigma: float, digits: int = 4) -> Fraction:
    """Round σ *up* to a rational s/t with ``digits`` decimal digits (§5.2)."""
    scale = 10 ** digits
    return Fraction(math.ceil(sigma * scale), scale)


def clique_gamma2(plan: BasePlan, clique: Clique, digits: int = 4
                  ) -> Tuple[Fraction, Fraction, int]:
    """Exact ``(σ̄_A, γ²_A, Π n_i)`` of one base mechanism (Alg 3 lines 1–2).

    One definition shared by ``measure_discrete``, the
    :class:`~repro_torch.engine.discrete_engine.DiscreteEngine` and the accounting
    helpers, so the served noise and the charged privacy always agree.
    """
    sigma_bar = rationalize_sigma(math.sqrt(plan.sigma2(clique)), digits)
    n_prod = 1
    for i in clique:
        n_prod *= plan.domain.attributes[i].size
    return sigma_bar, sigma_bar ** 2 * n_prod ** 2, n_prod


def discrete_pcost_of_plan(plan: BasePlan, digits: int = 4) -> float:
    """pcost (= 2ρ) actually spent by the discrete release of a whole plan.

    Σ_A 2·ρ_A with ρ_A = sens²(Ξ_A)/(2γ²_A) (Thm 6), computed exactly over
    the *rationalized* σ̄_A ≥ σ_A the mechanism really runs at — never more
    than the continuous plan's ``pcost_of_plan`` (rounding σ up only adds
    noise): what a secure release charges against a
    :class:`~repro_torch.core.accountant.PrivacyBudget`.
    """
    total = Fraction(0)
    for c in plan.cliques:
        sigma_bar, _, _ = clique_gamma2(plan, c, digits)
        total += discrete_zcdp_rho(plan.domain, c, sigma_bar)
    return float(2 * total)


@dataclass
class DiscreteMeasurement(Measurement):
    sigma_bar: Fraction = Fraction(0)
    gamma2: Fraction = Fraction(0)


def h_factors(dims: Sequence[int], dtype=np.float64) -> List[np.ndarray]:
    """H = ⊗_i (n_i·I - 1 1ᵀ):  H v = Ξ x, all-integer (Alg 3 line 4).

    The single definition of the rotation's forward factors — the host
    oracle below and the :class:`~repro_torch.engine.discrete_engine.DiscreteEngine`
    both build from here (``dtype=np.int64`` for the engine's exact tiers).
    """
    return [(n * np.eye(n) - np.ones((n, n))).astype(dtype) for n in dims]


def ypinv_factors(dims: Sequence[int]) -> List[np.ndarray]:
    """Y† = ⊗_i (1/n_i)·Sub_{n_i} (Alg 3 line 3) — shared like
    :func:`h_factors`."""
    return [sub_matrix(n) / n for n in dims]


def _h_factors(domain: Domain, clique: Clique) -> List[np.ndarray]:
    return h_factors([domain.attributes[i].size for i in clique])


def _ypinv_factors(domain: Domain, clique: Clique) -> List[np.ndarray]:
    return ypinv_factors([domain.attributes[i].size for i in clique])


def measure_discrete(plan: BasePlan, marginals: Mapping[Clique, np.ndarray],
                     rng, digits: int = 4,
                     sampler: str = "batched",
                     _noise_override=None) -> Dict[Clique, DiscreteMeasurement]:
    """Algorithm 3 for every base mechanism in the plan (host-exact reference).

    Outputs are drop-in replacements for the continuous measurements: same
    shapes, same unbiasedness, and (Thm 6) the same ρ-zCDP parameter as the
    continuous mechanism run at σ̄_A ≥ σ_A.

    ``rng`` is a ``random.Random`` or ``np.random.Generator``; ``sampler``
    picks the noise source — ``"batched"`` (default) draws every clique's
    lanes through :func:`repro_torch.core.dgauss.sample`, ``"legacy"`` keeps the
    historical one-value-at-a-time Fraction sampler (requires
    ``random.Random``; bench baseline).  Both are exact and seed-
    deterministic; their random streams differ.

    Transforms here are per-clique ``kron_matvec_np`` — the float64 oracle.
    Serving traffic goes through ``plan.engine(secure=True)``
    (:class:`~repro_torch.engine.discrete_engine.DiscreteEngine`), which runs
    H and Y† as signature-batched kernel chains.

    Consumes the unified plan protocol (``plan.domain`` / ``plan.cliques`` /
    ``plan.sigma2``); the rotation into integer queries is specific to
    identity bases, so RP+ plans (non-plain IR) are rejected.
    """
    if not getattr(plan.table, "plain", True):
        raise ValueError("measure_discrete requires a plain (identity-basis) "
                         "plan; RP+ plans have no integer-query rotation")
    if sampler not in ("batched", "legacy"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if _noise_override is not None:
        draw = _noise_override
    elif sampler == "legacy":
        if not isinstance(rng, random.Random):
            raise TypeError("sampler='legacy' requires a random.Random")
        draw = sample_discrete_gaussian_vec
    else:
        nrng = dgauss.as_np_rng(rng)
        draw = lambda g2, size, _r: dgauss.sample(g2, size, nrng)  # noqa: E731
    out: Dict[Clique, DiscreteMeasurement] = {}
    for clique in plan.cliques:
        dims = [plan.domain.attributes[i].size for i in clique]
        v = np.asarray(marginals[clique], dtype=np.float64).reshape(-1)
        sigma_bar, gamma2, n_prod = clique_gamma2(plan, clique, digits)
        if not clique:
            z = draw(gamma2, 1, rng)
            omega = v + np.asarray(z, dtype=np.float64)
            out[clique] = DiscreteMeasurement(clique, omega, float(sigma_bar ** 2),
                                              sigma_bar, gamma2)
            continue
        hv = kron_matvec_np(_h_factors(plan.domain, clique), v, dims)  # = Ξx
        z = draw(gamma2, n_prod, rng)
        noisy = hv + np.asarray(z, dtype=np.float64)
        omega = kron_matvec_np(_ypinv_factors(plan.domain, clique), noisy, dims)
        out[clique] = DiscreteMeasurement(clique, omega, float(sigma_bar ** 2),
                                          sigma_bar, gamma2)
    return out


def xi_l2_sensitivity2(domain: Domain, clique: Clique) -> int:
    """Squared L2 sensitivity of Ξ = Y R_A: Π_i n_i (n_i - 1) (integer, exact).

    Each record's column of Ξ is ⊗_i (n_i e_j - 1), with squared norm
    (n_i-1)² + (n_i-1) = n_i(n_i-1) per axis.
    """
    out = 1
    for i in clique:
        n = domain.attributes[i].size
        out *= n * (n - 1)
    return out


def discrete_zcdp_rho(domain: Domain, clique: Clique, sigma_bar: Fraction) -> Fraction:
    """ρ for the discrete mechanism: sens²/(2γ²) — equals p_A/(2σ̄²) (Thm 6)."""
    n_prod = 1
    for i in clique:
        n_prod *= domain.attributes[i].size
    gamma2 = sigma_bar ** 2 * n_prod ** 2
    return Fraction(xi_l2_sensitivity2(domain, clique)) / (2 * gamma2)


def naive_discrete_rho(plan: Plan, digits: int = 4) -> float:
    """ρ of the *naive* swap (Example 2): each M_A treated as sensitivity-1
    discrete-Gaussian marginal + post-processing ⇒ ρ_A = 1/(2σ̄²_A), losing the
    Π (n_i-1)/n_i factor (up to 2^k for k binary attributes).

    σ̄_A is rounded through :func:`rationalize_sigma` exactly like
    ``measure_discrete`` runs it (the historical version read the continuous
    ``plan.sigmas[A]``, making the Example-2 comparison slightly optimistic);
    with matching σ̄ the naive ρ dominates Σ_A ``discrete_zcdp_rho`` term by
    term.
    """
    total = Fraction(0)
    for c in plan.cliques:
        sigma_bar = rationalize_sigma(math.sqrt(plan.sigmas[c]), digits)
        total += Fraction(1) / (2 * sigma_bar ** 2)
    return float(total)
