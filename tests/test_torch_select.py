"""The port's planner IR and selectors vs the JAX package.

Both packages build their PlanTable from the same workload; σ² must agree to
rel 1e-9 (host float64 on both sides).  ``plan_from_arrays`` carries a JAX
plan's state into the port.  The device max-variance loop runs here with
``device="cpu"`` and is held to the float64 primal–dual gap; ``select_convex``
(Adam on a smoothed objective, float64 in the port, float32 in the JAX
package) is held to the JAX package's achieved loss at the tolerances
measured and stated beside each test.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import Domain as JDomain
from repro.core import MarginalWorkload as JWorkload
from repro.core import all_kway as jax_all_kway
from repro.core import select_max_variance as jax_maxvar
from repro.core import pcost_of_plan as jax_pcost_of_plan
from repro.core import select_sum_of_variances as jax_sov
from repro.core import select_convex as jax_convex
from repro.core import select_utility_constrained as jax_utility
from repro.core.select import legacy_maxvar_sigmas as jax_legacy_maxvar
from repro.core.select import legacy_sov_sigmas as jax_legacy_sov

from repro_torch.convert import plan_arrays, plan_from_arrays
from repro_torch.core import (CompositePlan, Domain, MarginalWorkload,
                              PlanTable, all_kway, closure, pcost_of_plan,
                              select, select_convex, select_max_variance,
                              select_sum_of_variances,
                              select_utility_constrained)
from repro_torch.core.select import (_maxvar_eval_fp64, legacy_maxvar_sigmas,
                                     legacy_sov_sigmas)
from repro_torch.engine import DiscreteEngine

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
    """Every objective dispatches to its ported selector; only the
    divide-and-conquer route still raises."""
    _, wk = _workloads([3, 4, 2], "all2")
    assert select(wk, objective="sov").objective == "sum_of_variances"
    assert select(wk, objective="maxvar").objective == "max_variance"
    cv = select(wk, objective="convex", steps=200, device="cpu")
    assert cv.objective == "max_variance" and cv.loss_value > 0

    def l2_of_variances(var):
        return torch.sqrt(torch.sum(var * var))

    p2 = select(wk, objective="convex", loss=l2_of_variances, steps=200,
                device="cpu")
    assert p2.objective == "l2_of_variances"
    p3 = select(wk, objective=l2_of_variances, steps=200, device="cpu")
    assert np.array_equal(p3.sigma, p2.sigma)
    assert select_convex(wk, steps=50, device="cpu").pcost == pytest.approx(
        1.0, rel=1e-9)
    assert select_max_variance(wk, backend="device", iters=20,
                               device="cpu").objective == "max_variance"
    assert isinstance(select_sum_of_variances(wk).engine(
        secure=True, device="cpu"), DiscreteEngine)
    assert isinstance(select_sum_of_variances(wk, strategy="dnc"),
                      CompositePlan)
    with pytest.raises(ValueError):
        select_sum_of_variances(wk, strategy="nope")
    with pytest.raises(ValueError):
        select_convex(wk, loss="nope", device="cpu")
    with pytest.raises(ValueError):
        select_max_variance(wk, backend="nope")


def _gap(plan):
    """(primal, dual) of a max-variance plan at its dual point, float64."""
    t = plan.table
    cw = t.weight_vector(None, default_to_workload=True)
    primal, _u, dual = _maxvar_eval_fp64(plan.mu, t.p, t.inc_rows, t.inc_cols,
                                         t.inc_vals, cw, plan.pcost, t.n, t.m)
    return primal, dual


@pytest.mark.parametrize("sizes,cliques,weighted", [
    ([5, 3, 4, 2], "all2", False), ([3, 5, 2, 7], "all<=3", True),
    ([3, 4, 2, 3], CASES[0][1], False)])
def test_maxvar_device_matches_numpy_within_the_gap(sizes, cliques, weighted):
    """Both loops certify their plans by the float64 primal–dual gap: each
    loss lies between its dual value and itself, and the two losses agree
    to within the sum of the two gaps (plus rel 1e-12 for the float64
    evaluation)."""
    _, wk = _workloads(sizes, cliques, weighted)
    a = select_max_variance(wk, 1.0, iters=1200, backend="numpy")
    b = select_max_variance(wk, 1.0, iters=1200, backend="device", chunk=100,
                            device="cpu")
    assert b.pcost == pytest.approx(1.0, rel=1e-9)
    pa, da = _gap(a)
    pb, db = _gap(b)
    assert b.loss_value == pytest.approx(pb, rel=1e-12)
    assert max(da, db) <= min(pa, pb) * (1 + 1e-12)   # weak duality
    assert abs(a.loss_value - b.loss_value) <= \
        (pa - da) + (pb - db) + 1e-12 * pa


def test_maxvar_device_matches_jax_device_backend():
    """The JAX package's device loop (float32 here, x64 off) reaches the
    same loss within rel 1e-4, its own test's tolerance against numpy."""
    jwk, wk = _workloads([5, 3, 4, 2], "all2")
    ref = jax_maxvar(jwk, 1.0, iters=1200, backend="device", chunk=100)
    mine = select_max_variance(wk, 1.0, iters=1200, backend="device",
                               chunk=100, device="cpu")
    assert mine.loss_value == pytest.approx(ref.loss_value, rel=1e-4)


def test_maxvar_device_warm_start_exits_early():
    _, wk = _workloads([5, 3, 4, 2], "all2")
    cold = select_max_variance(wk, 1.0, iters=2000, backend="device",
                               device="cpu", tol=1e-4)
    warm = select_max_variance(wk, 1.0, iters=2000, backend="device",
                               device="cpu", tol=1e-4, mu0=cold.mu)
    p, d = _gap(warm)
    assert p - d <= 1e-4 * p
    assert warm.loss_value <= cold.loss_value * (1 + 1e-4)
    with pytest.raises(ValueError):
        select_max_variance(wk, backend="device", device="cpu", mu0=[1.0, 2.0])


def test_maxvar_auto_takes_the_device_loop_from_20000_entries():
    """backend="auto" resolves by size: below 20,000 incidence entries the
    host loop, from there the device loop on ``device`` (CUDA by default, so
    it raises here unless the caller asks for the CPU)."""
    _, small = _workloads([3, 5, 2, 7], "all<=3")
    auto = select_max_variance(small, 1.0, iters=50)
    assert np.array_equal(auto.sigma,
                          select_max_variance(small, 1.0, iters=50,
                                              backend="numpy").sigma)
    big = all_kway(Domain.create([3] * 30), 3, include_lower=True)
    from repro_torch.core.plantable import plan_table
    assert plan_table(big).inc_vals.size >= 20_000
    cpu = select_max_variance(big, 1.0, iters=30, chunk=10, device="cpu")
    dev = select_max_variance(big, 1.0, iters=30, chunk=10, backend="device",
                              device="cpu")
    assert np.array_equal(cpu.sigma, dev.sigma)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            select_max_variance(big, 1.0, iters=30)


@pytest.mark.parametrize("sizes,steps", [([4, 3, 5], 2500), ([5, 3, 4, 2], 1500)])
def test_convex_matches_jax_achieved_loss(sizes, steps):
    """select_convex against the JAX package's *achieved* loss (not the
    1.02 bound the JAX package's own test fails).  Measured on the CPU:
    max-variance port/JAX 0.9911 ([4,3,5], 2500 steps) and 1.0135
    ([5,3,4,2], 1500), so rel 2e-2, and never below the exact optimum;
    the l2 callable and sum_of_variances within rel 2.2e-6 and 3.4e-7, so
    rel 1e-5."""
    jwk, wk = _workloads(sizes, "all2")
    ref = jax_convex(jwk, 1.0, loss="max_variance", steps=steps)
    mine = select_convex(wk, 1.0, loss="max_variance", steps=steps,
                         device="cpu")
    opt = select_max_variance(wk, 1.0, backend="numpy").loss_value
    assert mine.loss_value == pytest.approx(ref.loss_value, rel=2e-2)
    assert mine.loss_value >= opt * (1 - 1e-9)
    assert mine.loss_value == pytest.approx(mine.max_variance(), rel=1e-12)
    assert mine.pcost == pytest.approx(1.0, rel=1e-9)

    def l2_of_variances(var):
        return torch.sqrt(torch.sum(var * var))

    ref2 = jax_convex(jwk, 1.0, loss=lambda v: jnp.sqrt(jnp.sum(v * v)),
                      steps=steps)
    mine2 = select_convex(wk, 1.0, loss=l2_of_variances, steps=steps,
                          device="cpu")
    assert mine2.loss_value == pytest.approx(ref2.loss_value, rel=1e-5)
    got = float(np.sqrt(np.sum(mine2.variances_array() ** 2)))
    assert mine2.loss_value == pytest.approx(got, rel=1e-12)  # float64 call
    ref3 = jax_convex(jwk, 1.0, loss="sum_of_variances", steps=steps)
    mine3 = select_convex(wk, 1.0, loss="sum_of_variances", steps=steps,
                          device="cpu")
    assert mine3.loss_value == pytest.approx(ref3.loss_value, rel=1e-5)


@pytest.mark.parametrize("objective,gamma", [("sum_of_variances", 7.5),
                                             ("max_variance", 3.0)])
def test_utility_constrained_matches_jax(objective, gamma):
    jwk, wk = _workloads([5, 3, 4], "all2")
    ref = jax_utility(jwk, gamma, objective=objective)
    mine = select_utility_constrained(wk, gamma, objective=objective)
    assert mine.objective == ref.objective == objective + "_utility_constrained"
    assert _close(mine.sigma, ref.sigma, 1e-9)
    assert mine.pcost == pytest.approx(ref.pcost, rel=1e-9)
    assert mine.loss_value == gamma
    if objective == "max_variance":
        assert mine.max_variance() == pytest.approx(gamma, rel=1e-9)
    else:
        loss = sum(wk.weight(c) * mine.marginal_variance(c)
                   for c in wk.cliques)
        assert loss == pytest.approx(gamma, rel=1e-9)
        back = select_sum_of_variances(wk, pcost_of_plan(mine))
        assert _close(back.sigma, mine.sigma, 1e-9)


@pytest.mark.parametrize("sizes,cliques,weighted", [
    ([3, 4, 2, 3], CASES[0][1], False), ([5, 2, 7, 3, 4], "all2", True)])
def test_legacy_oracles_match_jax_and_the_ir(sizes, cliques, weighted):
    jwk, wk = _workloads(sizes, cliques, weighted)
    w = dict(wk.weights) if weighted else None
    mine, ref = legacy_sov_sigmas(wk, 1.0, w), jax_legacy_sov(jwk, 1.0, w)
    assert mine.keys() == ref.keys()
    assert all(mine[c] == pytest.approx(ref[c], rel=1e-12) for c in ref)
    ir = select_sum_of_variances(wk, 1.0, w)
    assert all(ir.sigmas[c] == pytest.approx(mine[c], rel=1e-12)
               for c in mine)
    sig, primal = legacy_maxvar_sigmas(wk, 1.0, w, iters=1500)
    rsig, rprimal = jax_legacy_maxvar(jwk, 1.0, w, iters=1500)
    assert primal == pytest.approx(rprimal, rel=1e-12)
    assert all(sig[c] == pytest.approx(rsig[c], rel=1e-9) for c in rsig)
    mv = select_max_variance(wk, 1.0, w, iters=1500, backend="numpy")
    assert mv.loss_value == pytest.approx(primal, rel=1e-6)
