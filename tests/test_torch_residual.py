"""The port's residual bases (``repro_torch.core.residual``) and
``kron_out_dims`` against the JAX package's, and the paper's Theorem 1 and
Lemma 1 on the port's own objects.

The helpers are numpy float64 in both packages, so parity is exact
(``np.array_equal`` for arrays, ``==`` for ``None`` and ``"ones"``).  The
dense checks materialize R_A and Q_A, so they run on small seeded domains;
the factor helpers also run on Adult's first four attributes.
"""
import numpy as np
import pytest

from repro.core import Domain as JDomain
from repro.core.kron import kron_out_dims as jax_kron_out_dims
from repro.core.residual import expand_marginal as jax_expand_marginal
from repro.core.residual import expand_residual as jax_expand_residual
from repro.core.residual import marginal_factors as jax_marginal_factors
from repro.core.residual import residual_factors as jax_residual_factors
from repro.core.residual import sigma_cov_factors as jax_sigma_cov_factors

from repro_torch.core import (Domain, all_kway, closure, expand_marginal,
                              expand_residual, marginal_factors,
                              residual_factors, subsets)
from repro_torch.core.kron import kron_expand, kron_matvec_np, kron_out_dims
from repro_torch.core.residual import (sigma_cov_factors, sub_gram,
                                       sub_matrix, sub_pinv)
from repro_torch.data import ADULT_SIZES


def _seeded_sizes(seed):
    rng = np.random.default_rng(seed)
    return [int(n) for n in rng.integers(2, 6, int(rng.integers(1, 5)))]


SMALL = [(3, 4, 5, 2), (2, 7, 3)] + [tuple(_seeded_sizes(s)) for s in range(6)]
ADULT4 = tuple(ADULT_SIZES[:4])


def _cliques(sizes, k=3):
    return closure(all_kway(Domain.create(list(sizes)), min(k, len(sizes)),
                            include_lower=True).cliques)


def _same_factors(a, b) -> bool:
    """Two factor lists equal entry for entry: ``None`` and strings by
    ``==``, matrices by ``np.array_equal`` (shape and every value)."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x is None or isinstance(x, str):
            if not (type(x) is type(y) and x == y):
                return False
        elif not (isinstance(y, np.ndarray) and x.dtype == y.dtype
                  and np.array_equal(x, y)):
            return False
    return True


@pytest.mark.parametrize("sizes", SMALL + [ADULT4], ids=str)
def test_factor_helpers_match_reference(sizes):
    dom, jdom = Domain.create(list(sizes)), JDomain.create(list(sizes))
    for c in _cliques(sizes):
        assert _same_factors(residual_factors(dom, c),
                             jax_residual_factors(jdom, c)), c
        assert marginal_factors(dom, c) == jax_marginal_factors(jdom, c), c
        assert _same_factors(sigma_cov_factors(dom, c),
                             jax_sigma_cov_factors(jdom, c)), c


@pytest.mark.parametrize("sizes", SMALL, ids=str)
def test_dense_helpers_match_reference(sizes):
    dom, jdom = Domain.create(list(sizes)), JDomain.create(list(sizes))
    for c in _cliques(sizes, k=len(sizes)):
        for mine, ref in ((expand_residual(dom, c), jax_expand_residual(jdom, c)),
                          (expand_marginal(dom, c), jax_expand_marginal(jdom, c))):
            assert mine.dtype == ref.dtype == np.float64
            assert np.array_equal(mine, ref), c


@pytest.mark.parametrize("seed", range(8))
def test_kron_out_dims_matches_reference(seed):
    rng = np.random.default_rng(seed)
    dims = [int(n) for n in rng.integers(1, 9, int(rng.integers(1, 7)))]
    factors = []
    for n in dims:
        kind = int(rng.integers(0, 3))
        factors.append(None if kind == 0 else "ones" if kind == 1
                       else rng.standard_normal((int(rng.integers(1, 6)), n)))
    got = kron_out_dims(factors, dims)
    assert got == jax_kron_out_dims(factors, dims)
    assert all(type(n) is int for n in got)


def test_kron_out_dims_on_residual_chains():
    dom, jdom = Domain.create(list(ADULT4)), JDomain.create(list(ADULT4))
    for c in _cliques(ADULT4):
        for mine, ref in ((residual_factors(dom, c), jax_residual_factors(jdom, c)),
                          (marginal_factors(dom, c), jax_marginal_factors(jdom, c))):
            assert (kron_out_dims(mine, dom.sizes)
                    == jax_kron_out_dims(ref, jdom.sizes))


# --------------------------------------------- Theorem 1 and Lemma 1, the port's own


@pytest.mark.parametrize("m", range(2, 14))
def test_sub_pinv_closed_form(m):
    """Lemma 1: Sub_m^† in closed form is the pseudo-inverse, and a right
    inverse of Sub_m."""
    s, sp = sub_matrix(m), sub_pinv(m)
    np.testing.assert_allclose(sp, np.linalg.pinv(s), rtol=0, atol=1e-10)
    np.testing.assert_allclose(s @ sp, np.eye(m - 1), rtol=0, atol=1e-10)
    np.testing.assert_allclose(s @ s.T, sub_gram(m), rtol=0, atol=0)


@pytest.mark.parametrize("sizes", SMALL, ids=str)
def test_residual_orthogonality(sizes):
    """Theorem 1: R_A R_Bᵀ = 0 for A ≠ B."""
    dom = Domain.create(list(sizes))
    cliques = closure([tuple(range(dom.n_attrs))])
    mats = {c: expand_residual(dom, c) for c in cliques}
    for a in cliques:
        for b in cliques:
            if a != b:
                assert np.abs(mats[a] @ mats[b].T).max() <= 1e-8, (a, b)


@pytest.mark.parametrize("sizes", SMALL, ids=str)
def test_residual_spans_marginal(sizes):
    """Theorem 1: the rows of {R_A' : A' ⊆ A} are a basis of rowspace(Q_A)."""
    dom = Domain.create(list(sizes))
    A = tuple(range(dom.n_attrs))
    Q = expand_marginal(dom, A)
    R = np.vstack([expand_residual(dom, c) for c in subsets(A)])
    assert R.shape == Q.shape
    assert np.linalg.matrix_rank(R) == R.shape[0]
    proj = R.T @ np.linalg.solve(R @ R.T, R @ Q.T)
    np.testing.assert_allclose(proj.T, Q, rtol=0, atol=1e-8)


@pytest.mark.parametrize("sizes", SMALL, ids=str)
def test_sigma_cov_factors(sizes):
    """⊗ sigma_cov_factors(A) = ⊗_{i∈A} sub_gram(n_i), and R_A R_Aᵀ is that
    times Π_{i∉A} n_i (each 'ones' row contributes 1·1ᵀ = n_i)."""
    dom = Domain.create(list(sizes))
    for c in _cliques(sizes, k=len(sizes)):
        sigma = kron_expand(sigma_cov_factors(dom, c))
        want = kron_expand([sub_gram(dom.sizes[i]) for i in c])
        assert np.array_equal(sigma, want), c
        r = expand_residual(dom, c)
        outside = np.prod([n for i, n in enumerate(dom.sizes) if i not in c])
        np.testing.assert_allclose(r @ r.T, outside * sigma, rtol=0, atol=1e-9)


@pytest.mark.parametrize("sizes", SMALL, ids=str)
def test_plain_chain_matches_dense(sizes):
    """The port's float64 chain on the factor forms equals the dense R_A
    and Q_A applied to the same vector (1e-12)."""
    dom = Domain.create(list(sizes))
    x = np.random.default_rng(len(sizes)).standard_normal(dom.universe_size())
    for c in _cliques(sizes, k=len(sizes)):
        for facs, dense in ((residual_factors(dom, c), expand_residual(dom, c)),
                            (marginal_factors(dom, c), expand_marginal(dom, c))):
            got = kron_matvec_np(facs, x, dom.sizes)
            want = dense @ x
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
