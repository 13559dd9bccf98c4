"""The port's baselines (``repro_torch.baselines``: HDMM and the SVD bound),
the CPS/Loans domains and the Adult config, against the JAX package.

Tolerances: the host float64 algebra of ``HdmmKron``/``HdmmUnion`` and the
SVD bound rel 1e-12 (the same numpy steps); ``hdmm_measure_reconstruct``
fed the reference's standard normal draws, rel 2e-5 of the reference's
max |answer| (float32 chains against float64 ones, the port's parity
bound); on the fused route (a universe that fits a 227 KB block) and on
the per-axis route (one that does not).  ``hdmm_generalized`` compares with
the reference's p-Identity strategies put into the port's cache, so both
sides hold the same ``A_i`` (their Adam loops run in float32 on different
backends).
"""
import math

import numpy as np
import pytest
import torch

from repro.baselines import hdmm as jax_hdmm
from repro.baselines import svdb as jax_svdb
from repro.configs import adult_marginals as jax_adult_marginals
from repro.core import Domain as JDomain
from repro.core import MarginalWorkload as JWorkload
from repro.core import all_kway as jax_all_kway
from repro.data import tabular as jax_tabular

from repro_torch.baselines import hdmm, svdb
from repro_torch.baselines import (HdmmKron, HdmmUnion, hdmm_generalized,
                                   hdmm_marginals, svd_bound_dense,
                                   svd_bound_marginals)
from repro_torch.baselines.hdmm import (OOM_GUARD_ELEMS,
                                        _measure_reconstruct,
                                        hdmm_measure_reconstruct)
from repro_torch.configs import adult_marginals
from repro_torch.core import Domain, MarginalWorkload, all_kway
from repro_torch.core import select_sum_of_variances
from repro_torch.core.kron import kron_expand, kron_matvec_np
from repro_torch.core.plus import PlusSchema, build_w, select_plus
from repro_torch.data import tabular
from repro_torch.data.tabular import synth_domain
from repro_torch.kernels.kron_matvec import chain_stats, reset_chain_stats

REL64 = 1e-12
REL32 = 2e-5
CPU = torch.device("cpu")


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _both(sizes, k, lower=True):
    return (all_kway(Domain.create(sizes), k, include_lower=lower),
            jax_all_kway(JDomain.create(sizes), k, include_lower=lower))


def _same_union(got, want):
    assert len(got.subs) == len(want.subs)
    for g, w in zip(got.subs, want.subs):
        assert _rel(g.tv_unit, w.tv_unit) < REL64
        assert _rel(g.maxvar_unit, w.maxvar_unit) < REL64
        assert g.n_queries == w.n_queries
        for ga, wa in zip(g.factors_A, w.factors_A):
            np.testing.assert_array_equal(ga, wa)
    np.testing.assert_allclose(got.shares, want.shares, rtol=REL64, atol=0)
    assert _rel(got.tv_unit, want.tv_unit) < REL64
    for budget in (1.0, 0.3):
        assert _rel(got.rmse(budget), want.rmse(budget)) < REL64
        assert _rel(got.max_variance(budget), want.max_variance(budget)) < REL64
        assert _rel(got.total_variance(budget),
                    want.total_variance(budget)) < REL64


def _query_variances(union, budget=1.0):
    """σ² of every answer of every sub-strategy: the Kronecker product of
    the per-axis diag(W_i (A_iᵀA_i)⁺ W_iᵀ), over share·budget."""
    out = []
    for sub, share in zip(union.subs, union.shares):
        v = np.ones(1)
        for W, A in zip(sub.factors_W, sub.factors_A):
            G = W @ np.linalg.pinv(A.T @ A) @ W.T
            v = np.kron(v, np.diag(G))
        out.append(v / (share * budget))
    return out


# ------------------------------------------------------------ HdmmKron/Union
@pytest.mark.parametrize("factors", [
    [np.eye(4), np.ones((1, 3))],
    [np.ones((1, 5)), np.eye(3), np.ones((1, 2))],
    [np.eye(2), np.eye(6)],
])
def test_hdmm_kron_matches_reference(factors):
    got = HdmmKron.optimize(factors, device="cpu")
    want = jax_hdmm.HdmmKron.optimize(factors)
    assert _rel(got.tv_unit, want.tv_unit) < REL64
    assert _rel(got.maxvar_unit, want.maxvar_unit) < REL64
    assert got.n_queries == want.n_queries
    for ga, wa in zip(got.factors_A, want.factors_A):
        np.testing.assert_array_equal(ga, wa)


@pytest.mark.parametrize("sizes,k,lower", [
    ([10, 10], 2, True), ([3, 4, 5, 2], 3, True), ([7, 2, 9, 4, 3], 2, False),
    (tabular.CPS_SIZES, 3, True),
])
def test_hdmm_marginals_union_matches_reference(sizes, k, lower):
    wk, jwk = _both(sizes, k, lower)
    _same_union(hdmm_marginals(wk), jax_hdmm.hdmm_marginals(jwk))


def test_hdmm_union_optimize_matches_reference():
    subs = [[np.eye(3), np.ones((1, 4))], [np.ones((1, 3)), np.eye(4)],
            [np.eye(3), np.eye(4)]]
    got = HdmmUnion.optimize([HdmmKron.optimize(f) for f in subs])
    want = jax_hdmm.HdmmUnion.optimize(
        [jax_hdmm.HdmmKron.optimize(f) for f in subs])
    _same_union(got, want)
    assert _rel(float(got.shares.sum()), 1.0) < REL64


@pytest.fixture
def share_pidentity(monkeypatch):
    """A call that puts the reference's p-Identity strategies into the
    port's cache (the keys are the same: W's shape and bytes, p, iters,
    seed); the port's cache is restored after the test."""
    cache = dict(hdmm._PIDENTITY_CACHE)
    monkeypatch.setattr(hdmm, "_PIDENTITY_CACHE", cache)
    return lambda: cache.update(jax_hdmm._PIDENTITY_CACHE)


@pytest.mark.parametrize("sizes,kinds", [
    ([8, 5, 3], ["prefix", "identity", "identity"]),
    ([6, 4, 5, 2], ["prefix", "prefix", "identity", "identity"]),
    ([5, 6, 3], ["range", "identity", "prefix"]),
])
def test_hdmm_generalized_matches_reference(sizes, kinds, share_pidentity):
    wk, jwk = _both(sizes, 3)
    want = jax_hdmm.hdmm_generalized(jwk, kinds, iters=40)
    share_pidentity()
    got = hdmm_generalized(wk, kinds, iters=40, device="cpu")
    _same_union(got, want)


# ----------------------------------------------- measure + reconstruct
def _replayed(seed):
    rng = np.random.default_rng(seed)
    return lambda m: torch.as_tensor(rng.standard_normal(m))


@pytest.mark.parametrize("sizes,k,kinds,route", [
    ([3, 4, 5], 3, None, "fused"),
    ([6, 5, 4, 3], 2, ["prefix", "identity", "identity", "range"], "fused"),
    ([10, 10, 10, 40], 2, None, "per_axis"),
    ([40, 30, 5, 6], 2, ["prefix", "prefix", "identity", "identity"],
     "per_axis"),
])
def test_measure_reconstruct_matches_reference(sizes, k, kinds, route,
                                              share_pidentity):
    wk, jwk = _both(sizes, k)
    if kinds is None:
        union, jun = hdmm_marginals(wk), jax_hdmm.hdmm_marginals(jwk)
    else:
        jun = jax_hdmm.hdmm_generalized(jwk, kinds, iters=30)
        share_pidentity()
        union = hdmm_generalized(wk, kinds, iters=30, device="cpu")
    dom = wk.domain
    x = np.random.default_rng(3).integers(0, 7, dom.universe_size())
    want = jax_hdmm.hdmm_measure_reconstruct(jun, jwk.domain, x,
                                             np.random.default_rng(11), 0.7)
    reset_chain_stats()
    got = _measure_reconstruct(union, dom, x, _replayed(11), 0.7, CPU)
    st = chain_stats()
    if route == "fused":
        assert st["fused_chains"] > 0 and st["fallback_chains"] == 0
    else:
        assert st["fallback_chains"] > 0
    assert st["fused_launches"] == st["axis_launches"] == 0   # CPU tensors
    assert len(got) == len(want)
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device == CPU
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= REL32 * scale


def test_measure_reconstruct_public_entry_on_cpu_within_6_sigma():
    """The public entry with a torch generator: every answer within 6σ of
    the exact ⊗W_i x, and the standardized squared errors' sum within a
    5σ χ² band (the answers are independent)."""
    wk = all_kway(Domain.create([6, 5, 4, 3]), 2, include_lower=True)
    union = hdmm_marginals(wk)
    dom = wk.domain
    x = np.random.default_rng(5).integers(0, 50, dom.universe_size())
    gen = torch.Generator().manual_seed(0)
    got = hdmm_measure_reconstruct(union, dom, torch.as_tensor(x), gen, 2.0,
                                   device="cpu")
    stat = n = 0
    for ans, var, sub in zip(got, _query_variances(union, 2.0), union.subs):
        exact = kron_matvec_np(sub.factors_W, x, dom.sizes)
        z = (ans.double().numpy() - exact) / np.sqrt(var)
        assert np.abs(z).max() < 6.0
        stat += float((z * z).sum())
        n += z.size
    assert abs(stat - n) < 5 * math.sqrt(2 * n)


def test_measure_reconstruct_same_generator_same_answers():
    wk = all_kway(Domain.create([3, 4, 5]), 2)
    union = hdmm_marginals(wk)
    x = np.arange(60)
    a = hdmm_measure_reconstruct(union, wk.domain, x,
                                 torch.Generator().manual_seed(4), device="cpu")
    b = hdmm_measure_reconstruct(union, wk.domain, x,
                                 torch.Generator().manual_seed(4), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_measure_reconstruct_rejects_a_wrong_universe():
    wk = all_kway(Domain.create([3, 4]), 1)
    with pytest.raises(ValueError, match="universe"):
        hdmm_measure_reconstruct(hdmm_marginals(wk), wk.domain, np.zeros(11),
                                 torch.Generator(), device="cpu")


# ------------------------------------------------ the reference's two tests
def test_hdmm_sanity_and_crossover_direction():
    """RP is optimal for marginals (HDMM ≥ RP); HDMM wins on the k=d Kron
    range workload (paper §9.4 crossover).  tests/test_engine.py's case."""
    dom = Domain.create([10, 10])
    wk = all_kway(dom, 2, include_lower=True)
    plan = select_sum_of_variances(
        wk, 1.0, {c: float(dom.n_cells(c)) for c in wk.cliques})
    union = hdmm_marginals(wk, iters=300)
    assert union.rmse(1.0) >= plan.rmse() * 0.999
    n, d = 8, 2
    dom2 = Domain.create([n] * d)
    wk2 = MarginalWorkload(dom2, (tuple(range(d)),))
    schema = PlusSchema.create(dom2, ["range"] * d, strategy_mode="hier",
                               device="cpu")
    rp = select_plus(wk2, schema, 1.0, "sov", device="cpu")
    kron = HdmmKron.optimize([build_w("range", n)] * d, iters=800,
                             device="cpu")
    hd_rmse = math.sqrt(kron.tv_unit / kron.n_queries)
    assert hd_rmse < rp.rmse() * 1.05


@pytest.mark.parametrize("device", [None, "cpu"])
def test_hdmm_reconstruction_oom_guard(device):
    """Synth-10^10 raises MemoryError at the reference's guard, before the
    device is resolved or anything is allocated."""
    assert OOM_GUARD_ELEMS == jax_hdmm.OOM_GUARD_ELEMS == 1 << 27
    dom = synth_domain(10, 10)
    union = hdmm_marginals(all_kway(dom, 1), iters=10)
    with pytest.raises(MemoryError):
        hdmm_measure_reconstruct(union, dom, np.zeros(1),
                                 torch.Generator(), device=device)


@pytest.mark.parametrize("d", [6, 8])
def test_universe_chains_never_plan_a_fused_launch(d, tmp_path, monkeypatch):
    """A one-row chain over a universe wider than a block (Synth-10^6 and
    10^8, m = 1 ones rows) plans the per-axis route, untuned and tuned
    with the H100 row of the cost model."""
    from repro_torch.kernels.autotune import tune_chain
    from repro_torch.kernels.kron_matvec.fused import (config_launch,
                                                       factor_shapes,
                                                       plan_chain)
    from repro_torch.roofline import DEVICE_TABLE
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    facs = [np.ones((1, 10))] * (d - 3) + [None] * 3
    dims = (10,) * d
    assert not plan_chain(facs, dims, batch=1).fused_ok
    for spec in (DEVICE_TABLE["cpu"], DEVICE_TABLE["nvidia h100 80gb hbm3"]):
        cfg = tune_chain(facs, dims, batch=1, spec=spec, device="cpu",
                         mode="model", persist=False)
        _, fused = config_launch(factor_shapes(facs, dims), dims, 1, None,
                                 cfg, False)
        assert not cfg.fused and not fused


def test_guard_admits_synth_10_8():
    assert synth_domain(10, 8).universe_size() <= OOM_GUARD_ELEMS
    assert synth_domain(10, 9).universe_size() > OOM_GUARD_ELEMS


# --------------------------------------------------------------- no card
def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    wk = all_kway(Domain.create([3, 4]), 2)
    union = hdmm_marginals(wk)
    with pytest.raises(RuntimeError, match="CUDA"):
        hdmm_measure_reconstruct(union, wk.domain, np.zeros(12),
                                 torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        hdmm_generalized(wk, ["prefix", "identity"], iters=5)


# ---------------------------------------------------------------- svdb
@pytest.mark.parametrize("sizes,k,lower,weights", [
    ([10, 10], 2, True, None), ([3, 4, 5, 2], 3, True, None),
    ([7, 2, 9, 4, 3], 2, False, "cells"), (tabular.CPS_SIZES, 3, True, None),
    (tabular.LOANS_SIZES, 2, True, "sqrt_cells"),
])
def test_svdb_matches_reference(sizes, k, lower, weights):
    wk, jwk = _both(sizes, k, lower)
    w = None if weights is None else dict(wk.reweighted(weights).weights)
    for budget in (1.0, 0.25):
        assert _rel(svd_bound_marginals(wk, budget, w),
                    jax_svdb.svd_bound_marginals(jwk, budget, w)) < REL64
        assert _rel(svdb.svdb_rmse_marginals(wk, budget),
                    jax_svdb.svdb_rmse_marginals(jwk, budget)) < REL64


def _dense_workload(wk):
    """The stacked marginal query matrix of ``wk`` (tiny domains only)."""
    rows = []
    for c in wk.cliques:
        facs = [np.eye(n) if i in c else np.ones((1, n))
                for i, n in enumerate(wk.domain.sizes)]
        rows.append(kron_expand(facs))
    return np.vstack(rows)


@pytest.mark.parametrize("sizes,k", [([3, 4], 2), ([2, 3, 4], 2),
                                     ([3, 3, 2], 3)])
def test_svdb_marginals_equals_the_dense_bound(sizes, k):
    wk = all_kway(Domain.create(sizes), k, include_lower=True)
    W = _dense_workload(wk)
    assert _rel(svd_bound_marginals(wk, 0.5), svd_bound_dense(W, 0.5)) < 1e-10
    assert _rel(svd_bound_dense(W, 0.5),
                jax_svdb.svd_bound_dense(W, 0.5)) < REL64


@pytest.mark.parametrize("sizes", [[12, 9, 7, 5, 3, 2], tabular.CPS_SIZES])
def test_table4_rp_equals_svdb(sizes):
    """Paper Table 4: for marginals ResidualPlanner's RMSE-optimal plan
    reaches the SVD bound (tests/test_selection.py's 1e-9)."""
    dom = Domain.create(sizes)
    wk = all_kway(dom, 3, include_lower=True)
    plan = select_sum_of_variances(
        wk, 1.0, {c: float(dom.n_cells(c)) for c in wk.cliques})
    assert abs(svdb.svdb_rmse_marginals(wk) - plan.rmse()) < 1e-9


# ------------------------------------------------------- schemas, config
@pytest.mark.parametrize("name", ["adult", "cps", "loans"])
def test_domains_equal_the_references(name):
    got = getattr(tabular, f"{name}_domain")()
    want = getattr(jax_tabular, f"{name}_domain")()
    assert got.sizes == want.sizes
    assert [a.name for a in got.attributes] == [a.name for a in want.attributes]
    assert getattr(tabular, f"{name.upper()}_SIZES") == \
        getattr(jax_tabular, f"{name.upper()}_SIZES")


@pytest.mark.parametrize("kmax,weights", [(3, "cells"), (2, "equi"),
                                          (1, "sqrt_cells")])
def test_adult_marginals_config_equals_the_references(kmax, weights):
    dom, wk = adult_marginals.make(kmax, weights)
    jdom, jwk = jax_adult_marginals.make(kmax, weights)
    assert dom.sizes == jdom.sizes
    assert wk.cliques == jwk.cliques
    assert dict(wk.weights) == dict(jwk.weights)
    assert isinstance(jwk, JWorkload) and isinstance(wk, MarginalWorkload)
