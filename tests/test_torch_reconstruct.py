"""The port's reconstruction phase vs the JAX package, on identical measurements."""
import numpy as np
import pytest

from repro.core import Domain as JDomain
from repro.core import MarginalWorkload as JWorkload
from repro.core import all_kway as jax_all_kway
from repro.core import exact_marginals_from_x
from repro.core import measure_np as jax_measure_np
from repro.core import reconstruct_all_batched as jax_reconstruct_batched
from repro.core import reconstruct_marginal as jax_reconstruct_marginal
from repro.core import select_sum_of_variances as jax_sov
from repro.core.reconstruct import embed_subset_answers as jax_embed
from repro.core.reconstruct import \
    marginal_covariance_dense as jax_cov_dense

from repro_torch.convert import plan_arrays, plan_from_arrays
from repro_torch.core import (Measurement, embed_group, embed_subset_answers,
                              marginal_covariance_dense, reconstruct_all,
                              reconstruct_all_batched, reconstruct_marginal,
                              u_chain_factors)


class _ZeroRng:
    def standard_normal(self, n):
        return np.zeros(n)


def _setup(sizes, cliques, rng, zero_noise=False):
    jdom = JDomain.create(sizes)
    jwk = (jax_all_kway(jdom, 3, include_lower=True) if cliques is None
           else JWorkload(jdom, tuple(cliques)))
    jplan = jax_sov(jwk, 1.0)
    plan = plan_from_arrays(*plan_arrays(jplan))
    x = rng.integers(0, 9, jdom.universe_size()).astype(float)
    margs = exact_marginals_from_x(jdom, jplan.cliques, x)
    jmeas = jax_measure_np(jplan, margs, _ZeroRng() if zero_noise else rng)
    meas = {c: Measurement(c, m.omega.astype(np.float32), m.sigma2)
            for c, m in jmeas.items()}
    return jplan, plan, jmeas, meas, margs


@pytest.mark.parametrize("sizes,cliques", [
    ([3, 4, 2, 4], [(0, 1), (1, 2), (2, 3), (0, 3)]),
    ([3, 5, 2, 7], None),
    ([4, 4, 4, 4, 4], None),
    ([4], [()]),
])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_reconstruct_batched_matches_jax(sizes, cliques, use_kernel, rng):
    jplan, plan, jmeas, meas, _ = _setup(sizes, cliques, rng)
    batched = jax_reconstruct_batched(jplan, jmeas, use_kernel=False)
    got = reconstruct_all_batched(plan, meas, use_kernel=use_kernel,
                                  device="cpu")
    assert set(got) == set(plan.workload.cliques)
    for c in plan.workload.cliques:
        oracle = jax_reconstruct_marginal(jplan, jmeas, c)
        scale = max(np.abs(oracle).max(), 1.0)
        assert got[c].shape == oracle.shape
        assert np.max(np.abs(got[c] - oracle)) / scale < 1e-5, c
        assert np.max(np.abs(got[c] - batched[c])) / scale < 1e-5, c


def test_zero_noise_reconstruction_is_the_exact_marginal(rng):
    _, plan, _, meas, margs = _setup([3, 5, 2, 7], None, rng, zero_noise=True)
    got = reconstruct_all_batched(plan, meas, device="cpu")
    for c in plan.workload.cliques:
        assert np.allclose(got[c], margs[c], rtol=1e-5, atol=1e-3), c


def test_reconstruct_oracles_match_jax(rng):
    jplan, plan, jmeas, _, _ = _setup([3, 4, 2], None, rng)
    mine = reconstruct_all(plan, jmeas)
    for c in plan.workload.cliques:
        want = jax_reconstruct_marginal(jplan, jmeas, c)
        assert np.allclose(mine[c], want, rtol=1e-12, atol=1e-9)
        assert np.allclose(reconstruct_marginal(plan, jmeas, c), want,
                           rtol=1e-12, atol=1e-9)
        assert np.array_equal(embed_subset_answers(plan, jmeas, c),
                              jax_embed(jplan, jmeas, c))
        assert np.allclose(marginal_covariance_dense(plan, c),
                           jax_cov_dense(jplan, c), rtol=1e-12)
    t = u_chain_factors(plan.domain, (0, 1))
    assert [f.shape for f in t] == [(3, 3), (4, 4)]


def test_group_embedding_equals_per_clique_embedding(rng):
    _, plan, jmeas, _, _ = _setup([4, 4, 4, 4, 4], None, rng)
    for k in (1, 2, 3):
        group = [c for c in plan.workload.cliques if len(c) == k]
        stacked = np.stack([embed_subset_answers(plan, jmeas, c, np.float32)
                            .reshape(-1) for c in group])
        assert np.array_equal(embed_group(plan, jmeas, group), stacked)
