"""The port's release subsystem against the JAX package's, on the CPU.

The same seeded numpy tables go through ``repro.release`` and
``repro_torch.release``.  Tolerances, set from the arithmetic:

* host fp64 CG ``r`` against the JAX package's host CG: rtol 1e-9 (both
  fp64; the scatter adds in another order);
* the port's CG against the fp64 ``dense_wls_oracle``: rtol 1e-9;
* the port's float32 "device" route (``device="cpu"``, plain versions of
  the kernels or the plain torch chain) against the JAX package's float32
  device route: atol 5e-5 of max|r| (the JAX package's own device-vs-host
  bound, ``tests/test_release.py``);
* non-negative totals: exact (one ulp; integers round-trip);
* synthesis: by distribution (χ² at z = 6 on a tree workload), never bit
  for bit — the two packages draw from different generators.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import Domain as JDomain
from repro.core import MarginalWorkload as JWorkload
from repro.core import all_kway as j_all_kway
from repro.core import measure_np as j_measure_np
from repro.core import reconstruct_all as j_reconstruct_all
from repro.core import select as j_select
from repro.core.mechanism import exact_marginals_from_x
import repro.release as J

from repro_torch.convert import plan_arrays, plan_from_arrays
from repro_torch.core import Domain
from repro_torch.release import (ConsistencyOperator, dense_wls_oracle,
                                 junction_order, measured_integer_total,
                                 mw_refine, nonneg_release,
                                 postprocess_release, precision_weights,
                                 project_nonneg, simplex_project_batch,
                                 solve_consistency, synth_report,
                                 synthesize_records)
from repro_torch.release.nonneg import _simplex_rows, _simplex_rows_np

DEVICE_ATOL = 5e-5     # of max|r|
CPU = "cpu"


def _setup(sizes, seed=0, kmax=2, pcost=1.0, cliques=None):
    """(jplan, plan, x, tables): one JAX plan, the port's copy of it, the
    data and the JAX package's host release of it."""
    dom = JDomain.create(list(sizes))
    wk = (j_all_kway(dom, min(kmax, dom.n_attrs), include_lower=True)
          if cliques is None else JWorkload(dom, tuple(cliques)))
    jplan = j_select(wk, pcost_budget=pcost)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 40, dom.universe_size()).astype(np.float64)
    margs = exact_marginals_from_x(dom, jplan.cliques, x)
    tables = j_reconstruct_all(jplan, j_measure_np(jplan, margs, rng))
    return jplan, plan_from_arrays(*plan_arrays(jplan)), x, tables


def _perturb(tables, seed=1, scale=5.0):
    rng = np.random.default_rng(seed)
    return {c: t + rng.normal(0, scale, t.shape) for c, t in tables.items()}


def _assert_total(t, total):
    """Total preserved to within one ulp; integer totals round-trip exactly."""
    assert abs(t.sum() - total) <= 2 * np.spacing(max(abs(total), 1.0))
    if float(total).is_integer():
        assert round(float(t.sum())) == int(total)


def _close(got, want, tol):
    """max|got - want| within ``tol`` of max(1, max|want|)."""
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


# ---------------------------------------------------------------- consistency

@pytest.mark.parametrize("sizes,kmax", [([3, 4, 2, 3], 2), ([3, 4, 2], 3),
                                        ([2, 5, 3, 2, 4], 3)])
def test_operator_layout_equals_reference(sizes, kmax):
    """Slot indices built per group, vectorised, equal the JAX package's
    clique-by-clique ones; offsets, weights, α and the preconditioner's
    blocks agree."""
    jplan, plan, _, _ = _setup(sizes, kmax=kmax)
    ref, mine = J.ConsistencyOperator(jplan), ConsistencyOperator(plan)
    assert mine.offsets == ref.offsets and mine.n_coords == ref.n_coords
    np.testing.assert_allclose(mine.weights, ref.weights, rtol=1e-12)
    for rg, mg in zip(ref.groups, mine.groups):
        assert rg.dims == mg.dims and rg.cliques == mg.cliques
        assert np.array_equal(rg.idx, mg.idx)
        np.testing.assert_allclose(mg.w, rg.w, rtol=1e-12)
    for rg, mg in zip(ref.pregroups, mine.pregroups):
        assert rg.rdims == mg.rdims and np.array_equal(rg.ridx, mg.ridx)
        np.testing.assert_allclose(mg.alpha, rg.alpha, rtol=1e-12)
    for c in plan.cliques:
        assert np.array_equal(mine._slot_index(c), ref._slot_index(c)), c


def test_operator_on_a_dict_closure_table():
    """A clique too wide for the IR's int64 keys (9 of 128 attributes): the
    plan's table keeps a clique index instead of sorted member keys, and
    the operator's lookup takes that route."""
    dom = JDomain.create([2] * 128)
    jplan = j_select(JWorkload(dom, (tuple(range(9)),)), pcost_budget=1.0)
    plan = plan_from_arrays(*plan_arrays(jplan))
    assert plan.table._members is None
    ref, mine = J.ConsistencyOperator(jplan), ConsistencyOperator(plan)
    assert all(np.array_equal(a.idx, b.idx)
               for a, b in zip(ref.groups, mine.groups))
    rng = np.random.default_rng(9)
    tables = {c: rng.normal(50.0, 5.0, 2 ** len(c))
              for c in plan.workload.cliques}
    np.testing.assert_allclose(
        solve_consistency(plan, tables, backend="host").r,
        J.solve_consistency(jplan, tables, backend="host").r,
        rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("sizes,kmax,seed", [([3, 4, 2, 3], 2, 0),
                                             ([3, 4, 2], 3, 1),
                                             ([2, 5, 3, 2, 4], 2, 2)])
def test_host_cg_matches_reference_and_dense_oracle(sizes, kmax, seed):
    jplan, plan, _, tables = _setup(sizes, seed=seed, kmax=kmax)
    pert = _perturb(tables, seed)
    ref = J.solve_consistency(jplan, pert, backend="host")
    mine = solve_consistency(plan, pert, backend="host")
    np.testing.assert_allclose(mine.r, ref.r, rtol=1e-9, atol=1e-9)
    assert mine.iterations == ref.iterations
    dense = dense_wls_oracle(plan, pert)
    np.testing.assert_allclose(mine.r, dense.r, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(dense.r, J.dense_wls_oracle(jplan, pert).r,
                               rtol=1e-9, atol=1e-9)
    # the fitted family is mutually consistent: shared sub-marginals agree
    fit = mine.marginals()
    m01 = fit[(0, 1)].reshape(sizes[0], sizes[1])
    m12 = fit[(1, 2)].reshape(sizes[1], sizes[2])
    np.testing.assert_allclose(m01.sum(axis=0), m12.sum(axis=1), atol=1e-8)


def test_cg_single_iteration_with_marginal_weights():
    """Per-marginal precision weights: the Kron-factored preconditioner is
    exact, the host CG converges in one or two steps."""
    _, plan, _, tables = _setup([3, 4, 2, 3])
    cg = solve_consistency(plan, _perturb(tables), backend="host")
    assert cg.iterations <= 2 and cg.rel_residual < 1e-9


def test_cg_cell_weights_vs_oracle_and_reference():
    """Per-cell weights break the block-diagonal decoupling: the CG iterates
    and still reaches the dense WLS optimum, on both routes."""
    jplan, plan, _, tables = _setup([3, 4, 2])
    pert = _perturb(tables)
    rng = np.random.default_rng(5)
    cw = {c: rng.uniform(0.2, 2.0, tables[c].size)
          for c in plan.workload.cliques}
    cg = solve_consistency(plan, pert, cell_weights=cw, backend="host",
                           tol=1e-12, maxiter=500)
    dense = dense_wls_oracle(plan, pert, cell_weights=cw)
    assert cg.iterations > 2
    _close(cg.r, dense.r, 1e-8)
    ref = J.solve_consistency(jplan, pert, cell_weights=cw, backend="host",
                              tol=1e-12, maxiter=500)
    _close(cg.r, ref.r, 1e-9)
    dev = solve_consistency(plan, pert, cell_weights=cw, device=CPU,
                            tol=1e-12, maxiter=500)
    _close(dev.r, dense.r, DEVICE_ATOL)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("fix_total", [None, 1234.0])
def test_device_route_matches_reference_device_route(use_kernel, fix_total):
    jplan, plan, _, tables = _setup([3, 4, 2, 3])
    pert = _perturb(tables)
    ref = J.solve_consistency(jplan, pert, backend="device",
                              fix_total=fix_total)
    host = solve_consistency(plan, pert, backend="host", fix_total=fix_total)
    mine = solve_consistency(plan, pert, device=CPU, use_kernel=use_kernel,
                             fix_total=fix_total)
    _close(mine.r, ref.r, DEVICE_ATOL)
    _close(mine.r, host.r, DEVICE_ATOL)
    again = solve_consistency(plan, pert, device=CPU, use_kernel=use_kernel,
                              fix_total=fix_total)
    assert np.array_equal(mine.r, again.r)          # two calls, one result


def test_fix_total_pins_every_marginal_sum():
    jplan, plan, _, tables = _setup([3, 4, 2])
    cg = solve_consistency(plan, _perturb(tables), fix_total=1234.0,
                           backend="host")
    assert cg.total == 1234.0
    for q in cg.marginals().values():
        assert abs(q.sum() - 1234.0) < 1e-6 * 1234.0
    dev = solve_consistency(plan, _perturb(tables), fix_total=1234.0,
                            device=CPU)
    assert dev.total == 1234.0
    dense = dense_wls_oracle(plan, _perturb(tables, 2), fix_total=777.0)
    assert dense.total == 777.0
    _close(dense.r, J.dense_wls_oracle(jplan, _perturb(tables, 2),
                                       fix_total=777.0).r, 1e-9)


@pytest.mark.parametrize("kwargs,match", [
    (dict(weights="zeros"), "strictly positive"),
    (dict(weights="long"), "shape"),
    (dict(backend="nope"), "backend"),
    (dict(dtype=torch.float64, device=CPU), "float32"),
])
def test_consistency_validation(kwargs, match):
    _, plan, _, tables = _setup([3, 4])
    m = len(plan.workload.cliques)
    kw = dict(kwargs)
    if kw.get("weights") == "zeros":
        kw["weights"] = np.zeros(m)
    elif kw.get("weights") == "long":
        kw["weights"] = np.ones(m + 1)
    with pytest.raises(ValueError, match=match):
        solve_consistency(plan, tables, **kw)
    assert np.all(precision_weights(plan) > 0)
    # float64 runs on the plain torch chain
    solve_consistency(plan, tables, dtype=torch.float64, device=CPU,
                      use_kernel=False)


@pytest.mark.parametrize("sizes,seed", [([2, 3], 0), ([4, 2, 3], 11),
                                        ([3, 3, 2, 4], 7), ([2, 4, 4], 123)])
def test_idempotent_on_consistent_inputs(sizes, seed):
    """Reconstructions are already mutually consistent: the fit returns
    them unchanged, on the host and (to float32) on the device route."""
    _, plan, _, tables = _setup(sizes, seed=seed)
    scale = max(1.0, max(float(np.abs(t).max()) for t in tables.values()))
    host = solve_consistency(plan, tables, backend="host").marginals()
    dev = solve_consistency(plan, tables, device=CPU).marginals()
    for c in plan.workload.cliques:
        np.testing.assert_allclose(host[c] / scale, tables[c] / scale,
                                   atol=1e-9)
        np.testing.assert_allclose(dev[c] / scale, tables[c] / scale,
                                   atol=DEVICE_ATOL)


# ------------------------------------------------------------- non-negativity

@pytest.mark.parametrize("total", [10.0, 0.0, -4.0, 1e4])
def test_simplex_projection_matches_reference(total):
    rng = np.random.default_rng(3)
    y = rng.normal(2.0, 5.0, (7, 11))
    want = _simplex_rows_np(y, np.full(7, total))
    np.testing.assert_array_equal(want, J.nonneg._simplex_rows_np(
        y, np.full(7, total)))
    got = _simplex_rows(torch.as_tensor(y), torch.full((7,), total,
                                                       dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9 * max(total, 1))
    for backend in ("host", "device"):
        q = simplex_project_batch(y, total, backend=backend, device=CPU)
        ref = J.simplex_project_batch(y, total, backend=backend)
        np.testing.assert_allclose(q, ref, atol=1e-4 * max(abs(total), 1))
        assert np.all(q >= 0)
        if total <= 0:
            assert np.all(q == 0)
            continue
        np.testing.assert_allclose(q.sum(axis=1), total, rtol=1e-5)
        # projection optimality: moving mass between two active cells must
        # not improve the distance
        d = q - y
        for g in range(y.shape[0]):
            grad = d[g][q[g] > 1e-9 * total]
            assert grad.max() - grad.min() < 1e-4 * max(total, 1)


def test_project_nonneg_local_only_and_zero_total():
    dom = Domain.create([3, 4])
    tables = {(0,): np.array([5.0, -2.0, 3.0]),
              (1,): np.array([-1.0, 2.0, 2.0, 1.0])}
    out = project_nonneg(dom, tables, total=6.0, device=CPU)
    for t in out.values():
        assert np.all(t >= 0)
        _assert_total(t, 6.0)
    zero = project_nonneg(Domain.create([3, 2]),
                          {(0,): np.array([1.0, -2.0, 0.5])}, total=-4.0,
                          device=CPU)
    assert np.all(zero[(0,)] == 0.0)


@pytest.mark.parametrize("backend,tol", [("host", 1e-9), ("device", 1e-4)])
def test_nonneg_release_matches_reference(backend, tol):
    jplan, plan, x, tables = _setup([3, 4, 2, 3], pcost=0.05)
    total = float(x.sum())
    mine = nonneg_release(plan, tables, total=total, backend=backend,
                          device=CPU)
    ref = J.nonneg_release(jplan, tables, total=total, backend=backend)
    for c in plan.workload.cliques:
        assert np.all(mine[c] >= 0)
        _assert_total(mine[c], total)
        _close(mine[c], ref[c], tol)
    exact = exact_marginals_from_x(jplan.domain, plan.workload.cliques, x)
    raw_err = sum(np.abs(tables[c] - exact[c]).sum()
                  for c in plan.workload.cliques)
    nn_err = sum(np.abs(mine[c] - exact[c]).sum()
                 for c in plan.workload.cliques)
    assert nn_err <= raw_err               # projection toward the truth helps


@pytest.mark.parametrize("sizes,seed", [([2, 3], 4), ([4, 2, 3], 5),
                                        ([3, 3, 2], 6)])
def test_nonneg_totals_with_mw_round(sizes, seed):
    _, plan, x, tables = _setup(sizes, seed=seed, pcost=0.2)
    total = float(x.sum())
    out = nonneg_release(plan, _perturb(tables, seed, 3.0), total=total,
                         mw_rounds=1, device=CPU)
    for c in plan.workload.cliques:
        assert np.all(out[c] >= 0)
        _assert_total(out[c], total)


def test_mw_refine_reduces_inconsistency_like_reference():
    jplan, plan, x, tables = _setup([3, 4, 2], pcost=0.1)
    total = float(x.sum())
    projected = project_nonneg(plan.domain, tables, total, backend="host")

    def inconsistency(q):
        fit = solve_consistency(plan, q, fix_total=total,
                                backend="host").marginals()
        return sum(float(np.abs(fit[c] - q[c]).sum())
                   for c in plan.workload.cliques)

    refined = mw_refine(plan, projected, total, rounds=3, eta=0.8,
                        backend="host")
    ref = J.mw_refine(jplan, projected, total, rounds=3, eta=0.8,
                      backend="host")
    for c in plan.workload.cliques:
        assert np.all(refined[c] >= 0)
        _assert_total(refined[c], total)
        _close(refined[c], ref[c], 1e-9)
    assert inconsistency(refined) <= inconsistency(projected) + 1e-6
    # the device route from a float32 projection, as the JAX package's test
    projected = project_nonneg(plan.domain, tables, total, device=CPU)
    dev = mw_refine(plan, projected, total, rounds=3, eta=0.8, device=CPU)
    assert inconsistency(dev) <= inconsistency(projected) + 1e-6


# -------------------------------------------------------------------- synth

@pytest.mark.parametrize("sizes,cliques,attr_order", [
    ([3, 4, 2, 3], [(0, 1), (1, 2), (2, 3)], None),
    ([3, 4, 2, 3, 2], [(0, 1, 2), (2, 3), (1, 4), (0, 3)], None),
    ([2, 2, 2, 2], [(0,), (1, 2), (0, 3), (2, 3)], [3, 1, 0, 2]),
    ([3, 3, 3], [(0, 1), (1, 2), (0, 2), (0, 1, 2)], None),
])
def test_junction_order_equals_reference(sizes, cliques, attr_order):
    dom, jdom = Domain.create(sizes), JDomain.create(sizes)
    assert junction_order(dom, cliques, attr_order) == J.junction_order(
        jdom, cliques, attr_order)


def test_junction_order_chain_is_markov_and_rejects_uncovered():
    steps = junction_order(Domain.create([3, 4, 2, 3]), [(0, 1), (1, 2), (2, 3)])
    assert [s[0] for s in steps] == [0, 1, 2, 3]
    assert steps[1][2] == (0,) and steps[2][2] == (1,) and steps[3][2] == (2,)
    with pytest.raises(ValueError):
        junction_order(Domain.create([3, 4, 2]), [(0, 1)])


def _tree_release():
    cl = [(0, 1), (1, 2), (2, 3)]
    jplan, plan, x, tables = _setup([3, 4, 2, 3], seed=1, pcost=2.0,
                                    cliques=cl)
    total = float(x.sum())
    return plan, total, nonneg_release(plan, tables, total=total, device=CPU)


def test_synthesize_chi_square_on_tree_workload():
    """On a tree workload junction sampling is exact: sampled marginals
    match the released ones within sampling error (χ² check, z = 6)."""
    plan, total, nn = _tree_release()
    dom = plan.domain
    recs = synthesize_records(dom, nn, 120_000, torch.Generator().manual_seed(0),
                              device=CPU)
    assert recs.shape == (120_000, 4) and recs.dtype == np.int32
    for i, a in enumerate(dom.attributes):
        assert recs[:, i].min() >= 0 and recs[:, i].max() < a.size
    report = synth_report(dom, nn, recs, total=total)
    assert report.ok(z=6.0), report.summary()
    assert report.max_tv < 0.05
    # the JAX package's audit of the same records reads the same numbers
    ref = J.synth_report(JDomain.create(dom.sizes), nn, recs, total=total)
    for mine, theirs in zip(report.checks, ref.checks):
        assert (mine.clique, mine.dof) == (theirs.clique, theirs.dof)
        assert mine.chi2 == pytest.approx(theirs.chi2, rel=1e-12)
        assert mine.tv == pytest.approx(theirs.tv, rel=1e-12)


def test_synthesize_seeded_batched_and_errors():
    plan, _, nn = _tree_release()
    dom = plan.domain
    r1 = synthesize_records(dom, nn, 5000, torch.Generator().manual_seed(7),
                            device=CPU)
    r2 = synthesize_records(dom, nn, 5000, torch.Generator().manual_seed(7),
                            device=CPU)
    r3 = synthesize_records(dom, nn, 5000, torch.Generator().manual_seed(7),
                            batch=1024, device=CPU)
    assert np.array_equal(r1, r2)                  # one seed, one sample
    assert r3.shape == r1.shape == (5000, 4) and r3.dtype == np.int32
    assert np.array_equal(r1, r3)       # chunks draw the same uniforms in order
    with pytest.raises(ValueError):
        synthesize_records(dom, nn, 0, torch.Generator(), device=CPU)
    # a JAX draw of the same tables agrees in distribution
    jrecs = J.synthesize_records(JDomain.create(dom.sizes), nn, 5000,
                                 jax.random.PRNGKey(0))
    for c in [(0, 1), (2, 3)]:
        mine = synth_report(dom, {c: nn[c]}, r1).checks[0].tv
        theirs = synth_report(dom, {c: nn[c]}, jrecs).checks[0].tv
        assert mine < 0.05 and theirs < 0.05


# ----------------------------------------------------------- postprocess glue

@pytest.mark.parametrize("mode", ["consistent", "nonneg"])
def test_postprocess_release_modes_match_reference(mode):
    jplan, plan, x, tables = _setup([3, 4, 2])
    pert = _perturb(tables)
    kw = dict(total=float(x.sum())) if mode == "nonneg" else {}
    mine = postprocess_release(plan, pert, mode, device=CPU, **kw)
    ref = J.postprocess_release(jplan, pert, mode, **kw)
    assert set(mine) == set(plan.workload.cliques)
    scale = max(float(np.abs(ref[c]).max()) for c in ref)
    for c in ref:
        assert float(np.abs(mine[c] - ref[c]).max()) <= DEVICE_ATOL * scale
    if mode == "nonneg":
        assert all(np.all(t >= 0) for t in mine.values())
    with pytest.raises(ValueError):
        postprocess_release(plan, pert, "fancy", device=CPU)


def test_measured_integer_total_equals_reference():
    class Meas:
        def __init__(self, v):
            self.omega = np.array([v])
    for v in (1234.0, 1233.9999999, -2.0000001, 0.0):
        meas = {(): Meas(v)}
        assert measured_integer_total(meas) == J.measured_integer_total(meas)
        assert measured_integer_total(meas).is_integer()


def _chain_gap(q, sizes):
    """Largest disagreement of neighbouring chain tables on their shared
    attribute."""
    return max(np.abs(q[(i - 1, i)].reshape(sizes[i - 1], sizes[i]).sum(0)
                      - q[(i, i + 1)].reshape(sizes[i], sizes[i + 1]).sum(1)
                      ).max() for i in range(1, len(sizes) - 1))


def test_sparse_tree_synthesis_follows_the_chain_joint_in_both_packages():
    """Adult's chain (0,1),...,(12,13) on 48,842 Zipfian records: the
    projection clips many cells per table, so neighbouring nonneg tables
    disagree on their shared attribute (by the same ~130 counts in both
    packages) and junction sampling draws the chain joint of the tables,
    not the tables themselves.  Both packages' samples pass χ² at z = 6
    against that joint and give the same verdict against the released
    tables (``chip_smoke.py [release-adult-tree]`` gates on the joint)."""
    import importlib.util
    from pathlib import Path
    from repro.core import select_sum_of_variances as j_sov
    from repro_torch.core import select_sum_of_variances
    from repro_torch.core.domain import MarginalWorkload
    from repro_torch.data.tabular import (ADULT_SIZES, adult_domain,
                                          marginals_from_records,
                                          synthetic_records)
    from repro_torch.engine import MarginalEngine
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    adult = adult_domain()
    cl = tuple((i, i + 1) for i in range(13))
    plan = select_sum_of_variances(MarginalWorkload(adult, cl), 1.0)
    jplan = j_sov(JWorkload(JDomain.create(ADULT_SIZES), cl), 1.0)
    margs = marginals_from_records(adult, plan.cliques,
                                   synthetic_records(adult, 48_842, 0))
    raw, _ = MarginalEngine(plan, device=CPU).release(
        margs, torch.Generator().manual_seed(0))
    mine = nonneg_release(plan, raw, device=CPU)
    theirs = J.nonneg_release(jplan, raw)
    gap = _chain_gap(mine, ADULT_SIZES)
    assert gap > 10.0
    assert gap == pytest.approx(_chain_gap(theirs, ADULT_SIZES), rel=1e-3)
    n = 100_000
    samples = (synthesize_records(adult, mine, n,
                                  torch.Generator().manual_seed(0), device=CPU),
               J.synthesize_records(jplan.domain, theirs, n,
                                    jax.random.PRNGKey(0)))
    verdicts = []
    for recs, q in zip(samples, (mine, theirs)):
        joint = smoke.chain_implied_marginals(adult, q, adult.n_attrs)
        assert synth_report(adult, joint, recs).ok(z=6.0)
        verdicts.append(synth_report(adult, q, recs).ok(z=6.0))
    assert verdicts[0] == verdicts[1]
