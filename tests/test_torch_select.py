"""The port's planner IR and selectors vs the JAX package.

Both packages build their PlanTable from the same workload; σ² must agree to
rel 1e-9 (host float64 on both sides).  ``plan_from_arrays`` carries a JAX
plan's state into the port.
"""
import numpy as np
import pytest

from repro.core import Domain as JDomain
from repro.core import MarginalWorkload as JWorkload
from repro.core import all_kway as jax_all_kway
from repro.core import select_max_variance as jax_maxvar
from repro.core import pcost_of_plan as jax_pcost_of_plan
from repro.core import select_sum_of_variances as jax_sov

from repro_torch.convert import plan_arrays, plan_from_arrays
from repro_torch.core import (Domain, MarginalWorkload, PlanTable, all_kway,
                              closure, pcost_of_plan, select, select_convex,
                              select_max_variance, select_sum_of_variances)

CASES = [
    ([3, 4, 2, 3], [(0, 1), (1, 2), (2, 3), (0, 3), (1,)]),
    ([5, 2, 7, 3, 4], "all2"),
    ([3, 5, 2, 7], "all<=3"),
    ([10] * 6, "all<=3"),
]


def _workloads(sizes, cliques, weighted=False):
    jdom, dom = JDomain.create(sizes), Domain.create(sizes)
    if cliques == "all2":
        jwk, wk = jax_all_kway(jdom, 2), all_kway(dom, 2)
    elif cliques == "all<=3":
        jwk = jax_all_kway(jdom, 3, include_lower=True)
        wk = all_kway(dom, 3, include_lower=True)
    else:
        jwk = JWorkload(jdom, tuple(cliques))
        wk = MarginalWorkload(dom, tuple(cliques))
    if weighted:
        w = {c: float(1 + (hash(c) % 5)) for c in wk.cliques}
        jwk = JWorkload(jdom, jwk.cliques, w)
        wk = MarginalWorkload(dom, wk.cliques, w)
    return jwk, wk


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)) <= rel


@pytest.mark.parametrize("sizes,cliques", CASES)
@pytest.mark.parametrize("weighted", [False, True])
def test_sov_sigma_matches_jax(sizes, cliques, weighted):
    jwk, wk = _workloads(sizes, cliques, weighted)
    ref = jax_sov(jwk, 2.5)
    mine = select_sum_of_variances(wk, 2.5)
    assert mine.cliques == ref.cliques
    assert _close(mine.sigma, ref.sigma, 1e-9)
    assert _close(mine.variances_array(), ref.variances_array(), 1e-9)
    assert mine.pcost == pytest.approx(ref.pcost, rel=1e-12)
    assert mine.loss_value == pytest.approx(ref.loss_value, rel=1e-9)
    assert mine.rmse() == pytest.approx(ref.rmse(), rel=1e-9)
    assert mine.max_variance() == pytest.approx(ref.max_variance(), rel=1e-9)
    assert pcost_of_plan(mine) == pytest.approx(jax_pcost_of_plan(ref),
                                                rel=1e-12)
    a, b = wk.cliques[0], wk.cliques[-1]
    assert mine.marginal_covariance(a, b) == pytest.approx(
        ref.marginal_covariance(a, b), rel=1e-9)


@pytest.mark.parametrize("sizes,cliques", CASES[:3])
def test_maxvar_numpy_matches_jax(sizes, cliques):
    jwk, wk = _workloads(sizes, cliques)
    ref = jax_maxvar(jwk, 1.0, backend="numpy")
    mine = select_max_variance(wk, 1.0, backend="numpy")
    assert _close(mine.sigma, ref.sigma, 1e-9)
    assert mine.loss_value == pytest.approx(ref.loss_value, rel=1e-9)
    assert _close(mine.mu, ref.mu, 1e-9)
    auto = select_max_variance(wk, 1.0)          # "auto" is the numpy loop
    assert np.array_equal(auto.sigma, mine.sigma)


def test_plan_table_arrays_match_jax():
    jwk, wk = _workloads([3, 5, 2, 7], "all<=3")
    from repro.core.plantable import PlanTable as JPlanTable
    ref, mine = JPlanTable.for_workload(jwk), PlanTable.for_workload(wk)
    assert mine.cliques == ref.cliques == closure(wk.cliques)
    for name in ("p", "wk_index", "inc_rows", "inc_cols", "inc_vals", "v"):
        assert np.array_equal(getattr(mine, name), getattr(ref, name)), name
    sig = np.linspace(1.0, 2.0, mine.n)
    pairs = [((0, 1), (1, 2)), ((0,), (0, 3)), ((1, 2, 3), (0, 2))]
    assert np.allclose(mine.cross_covariances(sig, pairs),
                       ref.cross_covariances(sig, pairs), rtol=1e-12)
    p, rows, cols, vals = mine.device_arrays("cpu")
    assert np.array_equal(cols.numpy(), mine.inc_cols)
    assert np.array_equal(vals.numpy(), mine.inc_vals)


@pytest.mark.parametrize("sizes,cliques", CASES[:3])
def test_plan_from_arrays_round_trips(sizes, cliques):
    jwk, _ = _workloads(sizes, cliques, weighted=True)
    ref = jax_sov(jwk, 1.5)
    mine = plan_from_arrays(*plan_arrays(ref))
    assert mine.cliques == ref.cliques
    assert np.array_equal(mine.sigma, ref.sigma)
    assert _close(mine.variances_array(), ref.variances_array(), 1e-12)
    for c in ref.workload.cliques:
        assert mine.marginal_variance(c) == pytest.approx(
            ref.marginal_variance(c), rel=1e-12)
    again = plan_from_arrays(*plan_arrays(mine))
    assert np.array_equal(again.sigma, mine.sigma)


def test_plan_from_arrays_rejects_a_wrong_closure():
    sizes, wk, w, cl, sig = plan_arrays(jax_sov(_workloads([3, 4], "all2")[0]))
    with pytest.raises(ValueError):
        plan_from_arrays(sizes, wk, w, cl[::-1], sig)
    with pytest.raises(ValueError):
        plan_from_arrays(sizes, wk, w, cl, sig[:-1])
    with pytest.raises(ValueError):
        plan_from_arrays(sizes, wk, w[:-1], cl, sig)


def test_select_dispatch_and_unported_routes():
    _, wk = _workloads([3, 4, 2], "all2")
    assert select(wk, objective="sov").objective == "sum_of_variances"
    assert select(wk, objective="maxvar").objective == "max_variance"
    with pytest.raises(NotImplementedError):
        select(wk, objective="convex")
    with pytest.raises(NotImplementedError):
        select_convex(wk)
    with pytest.raises(NotImplementedError):
        select_sum_of_variances(wk, strategy="dnc")
    with pytest.raises(NotImplementedError):
        select_max_variance(wk, backend="device")
    with pytest.raises(NotImplementedError):
        select_sum_of_variances(wk).engine(secure=True)
    with pytest.raises(ValueError):
        select_sum_of_variances(wk, strategy="nope")
