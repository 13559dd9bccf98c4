"""The port's measurement phase vs the JAX package's float64 oracles.

Noise is never compared bit for bit across the packages (torch's generator
is not JAX's threefry).  The port draws one flat vector in ``plan.cliques``
order; the JAX oracle ``measure_np`` is fed that same vector through a
replay rng, and the chains are compared deterministically (rel 1e-5: float32
against float64).  The noise itself is checked by its moments.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import Domain as JDomain
from repro.core import MarginalWorkload as JWorkload
from repro.core import all_kway as jax_all_kway
from repro.core import exact_marginals_from_x as jax_exact
from repro.core import measure_np as jax_measure_np
from repro.core import residual_answer as jax_residual_answer
from repro.core import select_sum_of_variances as jax_sov
from repro.core import signature_groups as jax_signature_groups

from repro_torch.convert import plan_arrays, plan_from_arrays
from repro_torch.core import (Domain, MarginalWorkload, draw_noise,
                              exact_marginals_from_x, measure, measure_np,
                              measure_np_batched, residual_answer,
                              select_sum_of_variances, signature_groups)


class _Replay:
    """rng stand-in that hands out a fixed flat vector in order."""

    def __init__(self, flat):
        self.flat, self.pos = np.asarray(flat, np.float64), 0

    def standard_normal(self, n):
        out = self.flat[self.pos:self.pos + int(np.prod(n))].reshape(n)
        self.pos += out.size
        return out


def _plans(sizes, cliques, budget=1.0):
    jdom = JDomain.create(sizes)
    jwk = (jax_all_kway(jdom, 3, include_lower=True) if cliques is None
           else JWorkload(jdom, tuple(cliques)))
    jplan = jax_sov(jwk, budget)
    return jplan, plan_from_arrays(*plan_arrays(jplan))


def _margs(plan, seed):
    x = np.random.default_rng(seed).integers(0, 9, plan.domain.universe_size())
    return exact_marginals_from_x(plan.domain, plan.cliques, x.astype(float))


@pytest.mark.parametrize("sizes,cliques", [
    ([3, 4, 2, 3], [(0, 1), (1, 2), (2, 3), (0, 3), (1,)]),
    ([3, 5, 2, 7], None),
    ([4, 4, 4, 4, 4], None),
])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_measure_matches_jax_oracle_on_replayed_noise(sizes, cliques,
                                                      use_kernel):
    jplan, plan = _plans(sizes, cliques)
    margs = _margs(plan, 1)
    got = measure(plan, margs, torch.Generator().manual_seed(3),
                  use_kernel=use_kernel, device="cpu")
    z = draw_noise(plan, torch.Generator().manual_seed(3), "cpu")
    ref = jax_measure_np(jplan, margs, _Replay(z.numpy()))
    for c in plan.cliques:
        assert got[c].omega.shape == ref[c].omega.shape, c
        scale = max(np.abs(ref[c].omega).max(), 1.0)
        assert np.max(np.abs(got[c].omega - ref[c].omega)) / scale < 1e-5, c
        assert got[c].sigma2 == ref[c].sigma2


def test_batched_and_loop_are_bit_identical():
    _, plan = _plans([3, 5, 2, 7], None)
    margs = _margs(plan, 2)
    bat = measure(plan, margs, torch.Generator().manual_seed(9), device="cpu")
    loop = measure(plan, margs, torch.Generator().manual_seed(9),
                   batched=False, device="cpu")
    for c in plan.cliques:
        assert np.array_equal(bat[c].omega, loop[c].omega), c


def test_float64_measure_matches_oracle():
    jplan, plan = _plans([3, 4, 2], None)
    margs = _margs(plan, 4)
    got = measure(plan, margs, torch.Generator().manual_seed(5),
                  use_kernel=False, dtype=torch.float64, device="cpu")
    z = draw_noise(plan, torch.Generator().manual_seed(5), "cpu", torch.float64)
    ref = jax_measure_np(jplan, margs, _Replay(z.numpy()))
    for c in plan.cliques:
        assert got[c].omega.dtype == np.float64
        assert np.allclose(got[c].omega, ref[c].omega, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("k,diag", [(1, 2.0), (2, 4.0)])
def test_noise_moments(k, diag):
    """ω − Hv ~ N(0, σ² H Hᵀ): per entry mean 0 and variance σ²·diag(H Hᵀ),
    which is 2σ² for a one-attribute clique (Sub Subᵀ = I + 11ᵀ)."""
    dom = Domain.create([5] * 12)
    wk = MarginalWorkload(dom, tuple((i,) if k == 1 else (i, i + 1)
                                     for i in range(0, 12, k)))
    plan = select_sum_of_variances(wk, 1.0)
    cl = [c for c in plan.cliques if len(c) == k]
    margs = {c: np.zeros(dom.n_cells(c)) for c in plan.cliques}
    gen = torch.Generator().manual_seed(0)
    draws = []
    for _ in range(60):
        meas = measure(plan, margs, gen, device="cpu")
        draws.append(np.concatenate([meas[c].omega / math.sqrt(
            plan.sigmas[c] * diag) for c in cl]))
    z = np.concatenate(draws)
    n = z.size
    assert abs(z.mean()) < 5.0 / math.sqrt(n)
    assert abs(z.var() - 1.0) < 5.0 * math.sqrt(2.0 / n)


def test_measure_np_oracles_match_jax():
    jplan, plan = _plans([3, 4, 2, 3], [(0, 1), (1, 2), (2, 3), (0, 3)])
    margs = _margs(plan, 6)
    a = measure_np(plan, margs, np.random.default_rng(8))
    b = jax_measure_np(jplan, margs, np.random.default_rng(8))
    for c in plan.cliques:
        assert np.array_equal(a[c].omega, b[c].omega)
    z = np.random.default_rng(9).standard_normal(100_000)
    bat = measure_np_batched(plan, margs, _Replay(z))
    assert set(bat) == set(plan.cliques)


def test_signature_groups_and_residual_answer_match_jax():
    jplan, plan = _plans([3, 5, 3, 7], None)
    assert signature_groups(plan.domain, plan.cliques) == \
        jax_signature_groups(jplan.domain, jplan.cliques)
    margs = _margs(plan, 7)
    for c in [(0,), (1, 3), (0, 2, 3)]:
        want = np.asarray(jax_residual_answer(jplan.domain, c,
                                              jnp.asarray(margs[c])))
        for use_kernel in (True, False):
            got = residual_answer(plan.domain, c, torch.as_tensor(
                margs[c], dtype=torch.float32), use_kernel)
            assert np.allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_exact_marginals_match_jax():
    dom = Domain.create([3, 4, 2])
    x = np.random.default_rng(0).integers(0, 9, dom.universe_size())
    cl = [(), (0,), (1, 2), (0, 1, 2)]
    a = exact_marginals_from_x(dom, cl, x)
    b = jax_exact(JDomain.create([3, 4, 2]), cl, x)
    assert all(np.array_equal(a[c], b[c]) for c in cl)


def test_measure_rejects_a_wrong_marginal():
    _, plan = _plans([3, 4], [(0, 1)])
    margs = _margs(plan, 0)
    margs[(0, 1)] = np.zeros(5)
    with pytest.raises(ValueError):
        measure(plan, margs, torch.Generator(), device="cpu")
    with pytest.raises(ValueError):
        measure(plan, margs, torch.Generator(), batched=False, device="cpu")
