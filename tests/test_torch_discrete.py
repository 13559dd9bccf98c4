"""The port's accountant, discrete Gaussian sampler and Algorithm-3 helpers
against the JAX package.

All of these are host Python/numpy on both sides, so most comparisons are
exact: the sampler's integers from the same ``np.random.default_rng(seed)``,
σ̄ and γ² as Fractions, the rationalized pcost and ρ.  The accountant's
conversions are held to rel 1e-12 (the same float64 formulas; the bisections
run the same steps).
"""
import math
import random
from fractions import Fraction

import numpy as np
import pytest

from repro.core import Domain as JDomain
from repro.core import all_kway as jax_all_kway
from repro.core import accountant as jacc
from repro.core import dgauss as jdgauss
from repro.core import discrete as jdisc
from repro.core import select_sum_of_variances as jax_sov
from repro.core.kron import kron_matvec_np_batched as jax_np_batched

from repro_torch.convert import plan_arrays, plan_from_arrays
from repro_torch.core import accountant as acc
from repro_torch.core import dgauss
from repro_torch.core import discrete as disc
from repro_torch.core import exact_marginals_from_x
from repro_torch.core.kron import kron_matvec_np, kron_matvec_np_batched

_CHI2_CRIT_11 = 31.26     # chi-square critical value, 11 dof, alpha = 1e-3


def _plans(sizes, k=2, pcost=1.0):
    ref = jax_sov(jax_all_kway(JDomain.create(sizes), k, include_lower=True),
                  pcost)
    return ref, plan_from_arrays(*plan_arrays(ref))


# ---------------------------------------------------------------- accountant

@pytest.mark.parametrize("pcost", [1e-4, 0.01, 0.3, 1.0, 7.5, 120.0])
def test_accountant_conversions_match_jax(pcost):
    assert acc.zcdp_rho(pcost) == jacc.zcdp_rho(pcost)
    assert acc.gdp_mu(pcost) == jacc.gdp_mu(pcost)
    for eps in (0.0, 0.1, 1.0, 5.0, 800.0):
        assert acc.approx_dp_delta(pcost, eps) == pytest.approx(
            jacc.approx_dp_delta(pcost, eps), rel=1e-12, abs=1e-300)
    for delta in (1e-9, 1e-6, 1e-3):
        assert acc.approx_dp_eps(pcost, delta) == pytest.approx(
            jacc.approx_dp_eps(pcost, delta), rel=1e-12)


@pytest.mark.parametrize("eps,delta", [(0.5, 1e-6), (1.0, 1e-5), (8.0, 1e-9)])
def test_accountant_budgets_match_jax(eps, delta):
    assert acc.pcost_for_eps_delta(eps, delta) == pytest.approx(
        jacc.pcost_for_eps_delta(eps, delta), rel=1e-12)
    assert acc.pcost_for_rho(eps) == jacc.pcost_for_rho(eps)
    assert acc.pcost_for_mu(eps) == jacc.pcost_for_mu(eps)
    mine = acc.PrivacyBudget.from_approx_dp(eps, delta)
    ref = jacc.PrivacyBudget.from_approx_dp(eps, delta)
    assert mine.total_pcost == pytest.approx(ref.total_pcost, rel=1e-12)
    mine.charge(0.25 * mine.total_pcost)
    ref.charge(0.25 * ref.total_pcost)
    for k, v in ref.report().items():
        assert mine.report()[k] == pytest.approx(v, rel=1e-12), k
    with pytest.raises(acc.BudgetExhausted) as exc:
        mine.charge(mine.total_pcost, tenant="t")
    assert isinstance(exc.value, ValueError)
    assert exc.value.remaining_rho == pytest.approx(mine.remaining_rho)
    with pytest.raises(ValueError):
        acc.pcost_for_eps_delta(1.0, 1.5)


# ------------------------------------------------------------------- dgauss

@pytest.mark.parametrize("sigma2", [2, Fraction(25, 4), 10 ** 7 + 3,
                                    (1 << 61) - 3, (1 << 70) + 5,
                                    Fraction(10 ** 40 * 17, 4)])
def test_dgauss_draws_identical_to_jax(sigma2):
    """Both samplers are the same host numpy code: the same Generator state
    gives the same integers, dtype included (int64 or object lanes)."""
    mine = dgauss.sample(sigma2, 500, np.random.default_rng(3))
    ref = jdgauss.sample(sigma2, 500, np.random.default_rng(3))
    assert mine.dtype == ref.dtype
    assert np.array_equal(mine, ref)


def test_dgauss_chi_square_and_moments():
    """Distribution check as tests/test_dgauss.py makes it: χ² on the
    support grid at γ² = 2 (α = 1e-3) and the moments at γ² = 25/4."""
    s2, n = 2, 20000
    xs = dgauss.sample(s2, n, np.random.default_rng(0))
    z = sum(math.exp(-x * x / (2.0 * s2)) for x in range(-200, 201))
    chi, tail_p = 0.0, 1.0
    for k in range(-5, 6):
        p = math.exp(-k * k / (2.0 * s2)) / z
        tail_p -= p
        chi += (int(np.sum(xs == k)) - n * p) ** 2 / (n * p)
    tail_obs = int(np.sum(np.abs(xs) > 5))
    chi += (tail_obs - n * tail_p) ** 2 / (n * tail_p)
    assert chi < _CHI2_CRIT_11, chi
    s2 = Fraction(25, 4)
    ys = dgauss.sample(s2, 5000, np.random.default_rng(1)).astype(float)
    assert abs(ys.mean()) < 6 * math.sqrt(float(s2) / len(ys))
    assert 0.8 * float(s2) <= ys.var() <= 1.1 * float(s2)


def test_dgauss_rejects_floats_and_accepts_random():
    with pytest.raises(TypeError):
        dgauss.sample(2.0, 3, np.random.default_rng(0))
    a = dgauss.sample(3, 50, random.Random(5))
    b = jdgauss.sample(3, 50, random.Random(5))
    assert np.array_equal(a, b)


def test_scalar_sampler_identical_to_jax():
    mine = disc.sample_discrete_gaussian_vec(Fraction(9, 2), 40,
                                             random.Random(1))
    ref = jdisc.sample_discrete_gaussian_vec(Fraction(9, 2), 40,
                                             random.Random(1))
    assert list(mine) == list(ref)


# ----------------------------------------------------------------- discrete

@pytest.mark.parametrize("sizes,k", [([4, 3, 2], 2), ([7, 5, 9, 2], 3),
                                     ([10, 10, 10], 3)])
@pytest.mark.parametrize("digits", [2, 4, 6])
def test_gamma2_sigma_bar_and_rho_exact(sizes, k, digits):
    ref, mine = _plans(sizes, k, pcost=0.7)
    for c in ref.cliques:
        assert disc.clique_gamma2(mine, c, digits) == \
            jdisc.clique_gamma2(ref, c, digits)
        sb = disc.clique_gamma2(mine, c, digits)[0]
        assert disc.discrete_zcdp_rho(mine.domain, c, sb) == \
            jdisc.discrete_zcdp_rho(ref.domain, c, sb)
        assert disc.xi_l2_sensitivity2(mine.domain, c) == \
            jdisc.xi_l2_sensitivity2(ref.domain, c)
    assert disc.discrete_pcost_of_plan(mine, digits) == \
        jdisc.discrete_pcost_of_plan(ref, digits)
    assert disc.naive_discrete_rho(mine, digits) == \
        jdisc.naive_discrete_rho(ref, digits)
    assert disc.rationalize_sigma(1.23456789, digits) == \
        jdisc.rationalize_sigma(1.23456789, digits)


@pytest.mark.parametrize("dims", [(2,), (5, 3), (4, 2, 3)])
def test_factors_match_jax(dims):
    for a, b in zip(disc.h_factors(dims, np.int64),
                    jdisc.h_factors(dims, np.int64)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(disc.ypinv_factors(dims), jdisc.ypinv_factors(dims)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.int64, object, np.float64])
def test_batched_host_chain_preserves_dtype_and_matches_jax(dtype):
    dims = (4, 3, 5)
    rng = np.random.default_rng(2)
    x = rng.integers(-10 ** 6, 10 ** 6, (3, 60))
    if dtype is object:
        x = x.astype(object) * (10 ** 15)      # beyond int64 after the chain
    else:
        x = x.astype(dtype)
    facs = [f.astype(dtype) for f in disc.h_factors(dims, np.int64)]
    mine = kron_matvec_np_batched(facs, x, dims)
    ref = jax_np_batched(facs, x, dims)
    assert mine.dtype == ref.dtype == np.dtype(dtype)
    assert np.array_equal(mine, ref)
    if dtype is not object:
        want = np.stack([kron_matvec_np(facs, r, dims) for r in x])
        assert np.array_equal(mine.astype(np.float64), want)


@pytest.mark.parametrize("sampler", ["batched", "legacy"])
def test_measure_discrete_identical_to_jax(sampler):
    """The host-exact oracle: same plan, same marginals, same random source
    → the same measurements bit for bit (float64 numpy on both sides)."""
    ref, mine = _plans([4, 3, 2])
    x = np.random.default_rng(0).integers(0, 30, 24).astype(float)
    margs = exact_marginals_from_x(mine.domain, mine.cliques, x)
    if sampler == "batched":
        a = disc.measure_discrete(mine, margs, np.random.default_rng(9))
        b = jdisc.measure_discrete(ref, margs, np.random.default_rng(9))
    else:
        a = disc.measure_discrete(mine, margs, random.Random(9),
                                  sampler="legacy")
        b = jdisc.measure_discrete(ref, margs, random.Random(9),
                                   sampler="legacy")
    for c in ref.cliques:
        assert isinstance(a[c], disc.DiscreteMeasurement)
        assert np.array_equal(a[c].omega, b[c].omega), c
        assert a[c].sigma_bar == b[c].sigma_bar
        assert a[c].gamma2 == b[c].gamma2
        assert a[c].sigma2 == b[c].sigma2
    with pytest.raises(TypeError):
        disc.measure_discrete(mine, margs, np.random.default_rng(0),
                              sampler="legacy")
