"""Divide-and-conquer planning in the port against the JAX package.

Partitions and decompositions are the same arrays; the budget allocation
and the SoV σ² agree to rel 1e-12 (float64 host numpy on both sides, at
d = 40 and d = 500); max-variance blocks (numpy backend) to rel 1e-6 and
convex blocks to the rel 2e-2 that tests/test_torch_select.py uses for the
convex solver.  The port's CompositeEngine is checked by feeding its
measurements to the JAX package's CompositeEngine.reconstruct (the same z
in both, never the same generator: float32 tolerances), and by the
behaviours of tests/test_dnc.py (exact at a huge budget, straddler
products, the shared ∅, nonneg + synthesize, the engine-cache keying).
"""
import sys
import time
from itertools import combinations

import numpy as np
import pytest
import torch

import jax

from repro.core import Domain as JDomain
from repro.core import MarginalWorkload as JWorkload
from repro.core.composite import allocate_budget as j_allocate
from repro.core.composite import compare_with_monolithic as j_compare
from repro.core.composite import select_dnc as j_select_dnc
from repro.core.mechanism import Measurement as JMeasurement
from repro.core.partition import decompose as j_decompose
from repro.core.partition import partition_attributes as j_partition

from repro_torch.core import (CompositePlan, Domain, MarginalWorkload, Plan,
                              allocate_budget,
                              compare_with_monolithic, decompose,
                              interaction_weights, partition_attributes,
                              select, select_dnc, select_max_variance,
                              select_sum_of_variances)
from repro_torch.core.mechanism import exact_marginals_from_x
from repro_torch.core.partition import ROW_STRADDLER
from repro_torch.data.tabular import marginals_from_records, synthetic_records

CPU = dict(device="cpu")


def _both(sizes, cliques, weights=None):
    """The same workload in the port and in the JAX package."""
    w = dict(weights or {})
    return (MarginalWorkload(Domain.create(list(sizes)), tuple(cliques), w),
            JWorkload(JDomain.create(list(sizes)), tuple(cliques), w))


def _two_component():
    """Attributes {0,1,2} and {3,4,5} never co-occur: exactly 2 components."""
    return _both([2, 3, 4, 2, 3, 4],
                 ((), (0,), (1,), (0, 1), (1, 2), (0, 2), (3,), (3, 4),
                  (4, 5)), {(0, 1): 2.0, (3, 4): 3.0})


def _straddling():
    """One clique crosses the {0,1}/{2,3} cut when forced into two blocks."""
    return _both([2, 3, 4, 2], ((0,), (0, 1), (1, 2), (2, 3), (3,)),
                 {(1, 2): 2.0})


def _blocked(d, bs, k):
    """Disjoint groups of ``bs`` attributes, sizes (i % 9) + 2, all <=k-way
    inside each group: the interaction graph decomposes exactly."""
    cl = [()]
    for g in range(0, d, bs):
        for w in range(1, k + 1):
            cl.extend(combinations(range(g, min(g + bs, d)), w))
    return _both([(i % 9) + 2 for i in range(d)], cl)


def _all2(d):
    """d attributes, sizes (i % 9) + 2, all <=2-way with lower orders."""
    cl = [()] + [(i,) for i in range(d)] + list(combinations(range(d), 2))
    return _both([(i % 9) + 2 for i in range(d)], cl)


# ---------------------------------------------------------------------------
# Partitioner and decomposition: the same arrays as the JAX package
# ---------------------------------------------------------------------------

_PARTITION_CASES = {
    "components": (_two_component, {}),
    "blocks_int": (_two_component, dict(blocks=4)),
    "max_block": (lambda: _all2(10), dict(max_block=4)),
    "explicit_straddler": (_straddling, dict(blocks=[[0, 1], [2, 3]])),
    "blocked_d40": (lambda: _blocked(40, 5, 3), {}),
    "forced_split_d40": (lambda: _blocked(40, 5, 3), dict(max_block=3)),
}


@pytest.mark.parametrize("case", sorted(_PARTITION_CASES))
def test_partition_and_decompose_equal_the_reference(case):
    make, kw = _PARTITION_CASES[case]
    wk, jwk = make()
    part, jpart = partition_attributes(wk, **kw), j_partition(jwk, **kw)
    assert part.blocks == jpart.blocks
    assert part.cut_weight == jpart.cut_weight
    d, jd = decompose(wk, part), j_decompose(jwk, jpart)
    for name in ("row_block", "row_pos", "part_row", "part_block",
                 "part_pos", "part_cells", "row_weight"):
        assert np.array_equal(getattr(d, name), getattr(jd, name)), name
    assert d.empty_weight == jd.empty_weight
    for bw, jbw in zip(d.block_workloads, jd.block_workloads):
        assert bw.cliques == jbw.cliques
        assert [bw.weight(c) for c in bw.cliques] == \
            [jbw.weight(c) for c in jbw.cliques]
    active, adj = interaction_weights(wk)
    from repro.core.partition import interaction_weights as j_iw
    jactive, jadj = j_iw(jwk)
    assert np.array_equal(active, jactive) and np.array_equal(adj, jadj)


def test_forced_split_has_straddlers_and_validates():
    wk, _ = _straddling()
    d = decompose(wk, partition_attributes(wk, blocks=[[0, 1], [2, 3]]))
    assert d.n_straddlers == 1
    r = wk.cliques.index((1, 2))
    assert int(d.row_block[r]) == ROW_STRADDLER
    assert sorted(pc for _, pc in d.parts_of(r)) == [(1,), (2,)]
    with pytest.raises(ValueError, match="overlap"):
        partition_attributes(wk, blocks=[[0, 1, 2], [2, 3]])
    with pytest.raises(ValueError, match="cover"):
        partition_attributes(wk, blocks=[[0, 1], [2]])


@pytest.mark.parametrize("combine", ["max", "sum"])
def test_allocate_budget_equals_the_reference(combine):
    rng = np.random.default_rng(3)
    for V in (np.array([4.0, 1.0]), np.array([0.0, 5.0]),
              rng.uniform(0.01, 50.0, 17)):
        got, want = allocate_budget(V, 7.5, combine), j_allocate(V, 7.5,
                                                                combine)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        assert got.sum() == pytest.approx(7.5, rel=1e-12)
    with pytest.raises(ValueError):
        allocate_budget(np.array([1.0]), -1.0)
    with pytest.raises(ValueError):
        allocate_budget(np.array([1.0]), 1.0, combine="median")


# ---------------------------------------------------------------------------
# select_dnc against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["blocked_d40", "all2_d500"])
def test_select_dnc_sov_sigma_equals_the_reference(case):
    wk, jwk = _blocked(40, 5, 3) if case == "blocked_d40" else _all2(500)
    t0 = time.perf_counter()
    plan = select_dnc(wk, 2.0)
    secs = time.perf_counter() - t0
    jplan = j_select_dnc(jwk, 2.0)
    assert isinstance(plan, CompositePlan)
    assert plan.cliques == jplan.cliques
    np.testing.assert_allclose(plan.sigma, jplan.sigma, rtol=1e-12, atol=0)
    np.testing.assert_allclose(plan.variances_array(),
                               jplan.variances_array(), rtol=1e-12, atol=0)
    assert plan.pcost == pytest.approx(jplan.pcost, rel=1e-12)
    assert plan.loss_value == pytest.approx(jplan.loss_value, rel=1e-12)
    assert plan.decomposition.n_straddlers == \
        jplan.decomposition.n_straddlers
    assert secs < 5.0, f"select_dnc took {secs:.2f} s"


@pytest.mark.parametrize("objective,rel", [("max_variance", 1e-6),
                                           ("convex", 2e-2)])
def test_select_dnc_iterative_equals_the_reference(objective, rel):
    wk, jwk = _two_component()
    kw = dict(objective=objective)
    if objective == "convex":
        kw.update(loss="max_variance", steps=300)
        plan = select_dnc(wk, 1.3, device="cpu", **kw)
    else:
        plan = select_dnc(wk, 1.3, backend="numpy", **kw)
    jplan = j_select_dnc(jwk, 1.3, **kw)
    assert plan.pcost == pytest.approx(1.3, rel=1e-6)
    assert plan.loss_value == pytest.approx(jplan.loss_value, rel=rel)
    if objective == "max_variance":
        # the optimum is unique: every marginal's variance agrees too (the
        # convex solver stops short of it, where only its loss is compared)
        np.testing.assert_allclose(plan.variances_array(),
                                   jplan.variances_array(), rtol=rel)
        for bp in plan.block_plans:
            assert bp.mu is not None and len(bp.mu) == bp.table.m


@pytest.mark.parametrize("case", ["two_component", "blocked_d40"])
def test_compare_with_monolithic_is_exact_on_disjoint_blocks(case):
    wk, jwk = _two_component() if case == "two_component" else \
        _blocked(40, 5, 3)
    rep = compare_with_monolithic(wk, 1.5)
    assert rep["exact_partition"] == 1.0
    assert abs(rep["ratio"] - 1.0) < 1e-9
    assert rep["max_rel_marginal_diff"] < 1e-9
    jrep = j_compare(jwk, 1.5)
    assert rep["ratio"] == pytest.approx(jrep["ratio"], rel=1e-12)
    assert rep["n_blocks"] == jrep["n_blocks"]


def test_composite_plan_protocol():
    wk, _ = _two_component()
    dnc = select_dnc(wk, 1.0)
    mono = select_sum_of_variances(wk, 1.0)
    assert dnc.cliques[0] == () and dnc.cliques.count(()) == 1
    for c in dnc.cliques:
        assert dnc.sigma2(c) == pytest.approx(mono.sigma2(c), rel=1e-10)
    for a, b in [((0, 1), (1, 2)), ((0, 1), (3, 4)), ((3,), (4, 5))]:
        assert dnc.marginal_covariance(a, b) == pytest.approx(
            mono.marginal_covariance(a, b), rel=1e-10)
    wv = dnc.workload_variances()
    assert set(wv) == set(wk.cliques)
    with pytest.raises(KeyError):
        dnc.marginal_variance((0, 5))
    with pytest.raises(ValueError, match="secure"):
        dnc.engine(secure=True, **CPU)
    swk, _ = _straddling()
    sp = select_dnc(swk, 1.0, blocks=[[0, 1], [2, 3]])
    with pytest.raises(ValueError, match="straddles"):
        sp.marginal_covariance((1, 2), (3,))


def test_strategy_routing():
    wk, _ = _two_component()
    assert isinstance(select(wk, 1.0), Plan)
    assert isinstance(select(wk, 1.0, strategy="dnc"), CompositePlan)
    assert isinstance(select(wk, 1.0, strategy="auto", max_block=3),
                      CompositePlan)
    with pytest.raises(ValueError, match="strategy"):
        select(wk, 1.0, strategy="monolithic", blocks=2)
    with pytest.raises(ValueError, match="strategy"):
        select(wk, 1.0, strategy="bogus")
    for obj, kw in (("sum_of_variances", {}), ("max_variance", CPU),
                    ("convex", dict(steps=50, **CPU))):
        p = select(wk, 1.0, objective=obj, strategy="dnc", **kw)
        assert isinstance(p, CompositePlan) and p.objective == obj
    assert isinstance(select_max_variance(wk, strategy="dnc", **CPU),
                      CompositePlan)


def test_auto_switches_to_dnc_past_the_incidence_bound(monkeypatch):
    S = sys.modules["repro_torch.core.select"]
    wk, _ = _blocked(12, 4, 2)
    est = sum(1 << len(c) for c in wk.cliques)
    monkeypatch.setattr(S, "AUTO_DNC_NNZ", est)
    assert isinstance(select(wk, 1.0), Plan)
    monkeypatch.setattr(S, "AUTO_DNC_NNZ", est - 1)
    assert isinstance(select(wk, 1.0), CompositePlan)


# ---------------------------------------------------------------------------
# CompositeEngine
# ---------------------------------------------------------------------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _margs(plan, recs):
    return marginals_from_records(plan.domain, plan.cliques, recs)


@pytest.mark.parametrize("case", ["two_component", "straddler"])
def test_composite_reconstruct_equals_the_reference(case):
    """The JAX package's CompositeEngine, fed the port's measurements (the
    same ω, converted), reconstructs the same tables to float32."""
    if case == "two_component":
        (wk, jwk), kw = _two_component(), {}
    else:
        (wk, jwk), kw = _straddling(), dict(blocks=[[0, 1], [2, 3]])
    plan, jplan = select_dnc(wk, 3.0, **kw), j_select_dnc(jwk, 3.0, **kw)
    recs = synthetic_records(wk.domain, 500, seed=7)
    eng = plan.engine(**CPU)
    meas = eng.measure(_margs(plan, recs), _gen(11))
    tables = eng.reconstruct(meas)
    jmeas = {c: JMeasurement(c, np.asarray(m.omega), m.sigma2)
             for c, m in meas.items()}
    want = jplan.engine(precompile=False).reconstruct(jmeas)
    assert set(tables) == set(want) == set(wk.cliques)
    for c in wk.cliques:
        w = np.asarray(want[c], np.float64).ravel()
        np.testing.assert_allclose(np.asarray(tables[c], np.float64), w,
                                   rtol=1e-5, atol=1e-4 * max(1.0, abs(w).max()))


def test_composite_engine_exact_at_huge_budget_and_repeatable():
    wk, _ = _two_component()
    dnc = select_dnc(wk, 1e12)
    recs = synthetic_records(wk.domain, 300, seed=1)
    eng = dnc.engine(**CPU)
    tables, meas = eng.release(_margs(dnc, recs), _gen(0))
    assert set(meas) == set(dnc.cliques)
    x = np.zeros(wk.domain.universe_size())
    np.add.at(x, np.ravel_multi_index(recs.T, wk.domain.sizes), 1.0)
    truth = exact_marginals_from_x(wk.domain, wk.cliques, x)
    for c in wk.cliques:
        assert np.allclose(tables[c], truth[c], atol=1e-3), c
    again, _ = eng.release(_margs(dnc, recs), _gen(0))
    for c in wk.cliques:
        assert np.array_equal(again[c], tables[c]), c


def test_composite_engine_straddler_is_product_of_blocks():
    wk, _ = _straddling()
    dnc = select_dnc(wk, 1e12, blocks=[[0, 1], [2, 3]])
    recs = synthetic_records(wk.domain, 400, seed=2)
    tables, _ = dnc.engine(**CPU).release(_margs(dnc, recs), _gen(1))
    m1 = np.bincount(recs[:, 1], minlength=3).astype(float)
    m2 = np.bincount(recs[:, 2], minlength=4).astype(float)
    want = np.multiply.outer(m1, m2).ravel() / len(recs)
    assert np.allclose(tables[(1, 2)], want, atol=1e-2)


def test_composite_engine_straddler_products_equal_one_by_one():
    """The port's grouped products equal the JAX package's one-by-one
    loop (outer product, then division by T^(parts-1), then transpose)
    bit for bit, on three-part straddlers across three blocks."""
    sizes = [2, 3, 4, 5, 3, 2]
    cl = ((0, 1), (2, 3), (4, 5), (1, 2, 4), (0, 3, 5), (0, 2), (1, 5))
    wk, _ = _both(sizes, cl)
    dnc = select_dnc(wk, 5.0, blocks=[[0, 1], [2, 3], [4, 5]])
    eng = dnc.engine(**CPU)
    recs = synthetic_records(wk.domain, 600, seed=5)
    meas = eng.measure(_margs(dnc, recs), _gen(3))
    bt = eng._block_tables(meas)
    total = float(np.asarray(meas[()].omega).reshape(-1)[0])
    got = eng._assemble(bt, total, list(wk.cliques))
    d = dnc.decomposition
    for r, c in enumerate(wk.cliques):
        if d.row_block[r] != ROW_STRADDLER:
            continue
        parts = d.parts_of(r)
        tab, attrs = None, []
        for pb, pc in parts:
            pt = np.asarray(bt[pb][pc], float).reshape(
                wk.domain.clique_sizes(pc))
            tab = pt if tab is None else np.multiply.outer(tab, pt)
            attrs.extend(pc)
        tab = tab / total ** (len(parts) - 1)
        want = np.ascontiguousarray(np.transpose(
            tab, np.argsort(np.asarray(attrs)))).reshape(-1)
        assert np.array_equal(got[c], want), c


def _mixed_all3(d):
    """d attributes, sizes (i % 9) + 2, all <=3-way with lower orders (the
    d = 200 smoke workload's shape at a small width)."""
    cl = [()] + [c for w in (1, 2, 3) for c in combinations(range(d), w)]
    return _both([(i % 9) + 2 for i in range(d)], cl)


def _parts_per_row(dnc):
    d = dnc.decomposition
    strad = np.flatnonzero(d.row_block == ROW_STRADDLER)
    return np.bincount(d.part_row, minlength=len(d.row_block))[strad]


def test_auto_all3_release_equals_the_reference(monkeypatch):
    """select(strategy="auto") past AUTO_DNC_NNZ on an all-<=3-way workload
    of 12 attributes, split into blocks of at most 4: 2- and 3-part
    straddlers; the JAX package's CompositeEngine, fed the port's
    measurements, reconstructs every table to float32."""
    S = sys.modules["repro_torch.core.select"]
    wk, jwk = _mixed_all3(12)
    monkeypatch.setattr(S, "AUTO_DNC_NNZ",
                        sum(1 << len(c) for c in wk.cliques) - 1)
    plan = select(wk, 1.0, strategy="auto", max_block=4)
    jplan = j_select_dnc(jwk, 1.0, max_block=4)
    assert isinstance(plan, CompositePlan) and plan.n_blocks >= 3
    assert {2, 3} <= set(_parts_per_row(plan).tolist())
    from repro_torch.data.tabular import mixture_marginals
    exact = mixture_marginals(wk.domain, list(dict.fromkeys(
        list(plan.cliques) + list(wk.cliques))), 1e4, 0)
    eng = plan.engine(**CPU)
    meas = eng.measure(exact, _gen(8))
    tables = eng.reconstruct(meas)
    want = jplan.engine(precompile=False).reconstruct(
        {c: JMeasurement(c, np.asarray(m.omega), m.sigma2)
         for c, m in meas.items()})
    assert list(tables) == list(wk.cliques) and set(want) == set(wk.cliques)
    for c in wk.cliques:
        w = np.asarray(want[c], np.float64).ravel()
        np.testing.assert_allclose(np.asarray(tables[c], np.float64), w,
                                   rtol=1e-5, atol=1e-4 * max(1.0, abs(w).max()))


def _loop_groups(d):
    """The grouping loop ``CompositeEngine._straddler_groups`` ran before
    it was vectorized: ``{(part shapes, perm): [(row, [(block, part
    clique), ...]), ...]}``."""
    dom = d.workload.domain
    order = np.argsort(d.part_row, kind="stable")
    rows = d.part_row[order]
    cut = np.flatnonzero(np.diff(rows)) + 1
    groups = {}
    for grp in np.split(order, cut):
        if not grp.size:
            continue
        parts = [(int(d.part_block[i]), d.part_clique(i)) for i in grp]
        attrs = [a for _, pc in parts for a in pc]
        key = (tuple(dom.clique_sizes(pc) for _, pc in parts),
               tuple(np.argsort(np.asarray(attrs)).tolist()))
        groups.setdefault(key, []).append((int(d.part_row[grp[0]]), parts))
    return groups


def _loop_assemble(eng, block_tables, total, cliques):
    """The grouped assembly ``CompositeEngine._assemble`` ran over the
    grouping loop's lists (``_loop_groups``), before the grouping was
    vectorized."""
    from repro_torch.core.partition import ROW_EMPTY
    d = eng.plan.decomposition
    wk = d.workload.cliques
    rows = {c: r for r, c in enumerate(wk)}
    out, wanted = {}, set()
    for c in cliques:
        r = rows[c]
        b = int(d.row_block[r])
        if b >= 0:
            out[c] = block_tables[b][c]
        elif b == ROW_EMPTY:
            out[c] = np.asarray([total], dtype=float)
        else:
            wanted.add(r)
    for (shapes, perm), group in _loop_groups(d).items():
        members = [(r, parts) for r, parts in group if r in wanted]
        if not members:
            continue
        g, tab = len(members), None
        for p, shape in enumerate(shapes):
            pt = np.stack([block_tables[parts[p][0]][parts[p][1]]
                           for _, parts in members]
                          ).astype(np.float64).reshape((g,) + shape)
            tab = pt if tab is None else (
                tab.reshape(tab.shape + (1,) * len(shape))
                * pt.reshape((g,) + (1,) * (tab.ndim - 1) + shape))
        if len(shapes) > 1:
            tab = tab / float(total) ** (len(shapes) - 1)
        tab = np.transpose(tab, (0,) + tuple(q + 1 for q in perm))
        tab = np.ascontiguousarray(tab).reshape(g, -1)
        for i, (r, _) in enumerate(members):
            out[wk[r]] = tab[i]
    return {c: out[c] for c in cliques}


@pytest.mark.parametrize("d,max_block", [(9, 3), (12, 4), (14, 3)])
def test_straddler_groups_equal_the_loop(d, max_block):
    """The vectorized grouping has the loop's keys in the loop's order, and
    each group the loop's members (rows and their (block, part clique)
    pairs) in the loop's order, on forced splits with 2- and 3-part
    straddlers."""
    from repro_torch.engine.composite import straddler_groups
    wk, _ = _mixed_all3(d)
    dnc = select_dnc(wk, 1.0, max_block=max_block)
    assert {2, 3} <= set(_parts_per_row(dnc).tolist())
    dec = dnc.decomposition
    want = _loop_groups(dec)
    got = straddler_groups(dec)
    assert list(got) == list(want)
    for key, grp in got.items():
        members = [(int(r), [(int(b), dec.block_workloads[b].cliques[p])
                             for b, p in zip(bs.tolist(), ps.tolist())])
                   for r, bs, ps in zip(grp.rows, grp.blocks, grp.pos)]
        assert members == want[key], key


@pytest.mark.parametrize("subset", ["all", "every_third_reversed"])
def test_composite_assemble_equals_the_loop_assembly(subset):
    """The assembly over the vectorized groups equals the one over the
    loop's lists bit for bit (values, dtype, shape, order of the keys), for
    the whole workload and for a reordered subset, raw and after
    nonneg."""
    wk, _ = _mixed_all3(12)
    dnc = select_dnc(wk, 1.0, max_block=4)
    from repro_torch.data.tabular import mixture_marginals
    exact = mixture_marginals(wk.domain, list(dict.fromkeys(
        list(dnc.cliques) + list(wk.cliques))), 1e4, 0)
    eng = dnc.engine(**CPU)
    meas = eng.measure(exact, _gen(4))
    bt = eng._block_tables(meas)
    total = float(np.asarray(meas[()].omega).reshape(-1)[0])
    cliques = list(wk.cliques)
    if subset != "all":
        cliques = cliques[::-3]
    for tables in (bt, [{c: np.maximum(t, 0) for c, t in b.items()}
                        for b in bt]):
        got = eng._assemble(tables, total, cliques)
        want = _loop_assemble(eng, tables, total, cliques)
        assert list(got) == list(want) == cliques
        for c in cliques:
            assert (np.array_equal(got[c], want[c])
                    and got[c].dtype == want[c].dtype
                    and got[c].shape == want[c].shape), c


@pytest.mark.parametrize("batch_cells", [None, 64])
def test_mixture_marginals_equal_the_per_clique_loop(monkeypatch,
                                                     batch_cells):
    """The batched mixture marginals equal the per-clique products and sum
    bit for bit, for cliques of widths 0 to 4 in any order, in one batch
    per size signature or cut into batches of at most 64 cells."""
    import repro_torch.data.tabular as tab
    from repro_torch.data.tabular import mixture_marginals
    if batch_cells:
        monkeypatch.setattr(tab, "_MIXTURE_BATCH_CELLS", batch_cells)
    dom = Domain.create([(i % 9) + 2 for i in range(11)])
    rng = np.random.default_rng(2)
    cl = [()] + [c for w in (1, 2, 3, 4) for c in combinations(range(11), w)]
    cl = [cl[i] for i in rng.permutation(len(cl))]
    got = mixture_marginals(dom, cl, 1e6, 5)
    rng = np.random.default_rng(5)
    w = rng.dirichlet(np.ones(4)) * 1e6
    probs = [rng.dirichlet(np.ones(a.size), size=4) for a in dom.attributes]
    assert list(got) == cl
    for c in cl:
        t = w[:, None]
        for i in c:
            t = (t[:, :, None] * probs[i][:, None, :]).reshape(4, -1)
        want = t.sum(axis=0)
        assert (np.array_equal(got[c], want) and got[c].dtype == want.dtype
                and got[c].shape == want.shape), c


def test_smoke_straddler_gate_holds_the_noise_and_catches_a_wrong_table():
    """``chip_smoke.py``'s straddler gate (``straddler_dev``: the product of
    the exact parts, the delta-method sigma) holds the port's and the JAX
    package's straddlers, reconstructed from the same measurements, within
    6 sigma over 108 forced-split straddlers, and puts one table scaled by
    1.01 far outside."""
    import importlib.util
    from pathlib import Path
    from repro_torch.data.tabular import mixture_marginals
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    wk, jwk = _both([(i % 3) + 2 for i in range(9)],
                    [c for w in range(1, 4) for c in combinations(range(9), w)])
    dnc = select_dnc(wk, 0.5, max_block=3)
    jplan = j_select_dnc(jwk, 0.5, max_block=3)
    strad = np.flatnonzero(dnc.decomposition.row_block == ROW_STRADDLER)
    assert strad.size == 108
    exact = mixture_marginals(wk.domain, list(dict.fromkeys(
        list(dnc.cliques) + list(wk.cliques))), 1e4, 0)
    eng = dnc.engine(**CPU)
    for seed in range(3):
        meas = eng.measure(exact, _gen(seed))
        tables = eng.reconstruct(meas)
        want = jplan.engine(precompile=False).reconstruct(
            {c: JMeasurement(c, np.asarray(m.omega), m.sigma2)
             for c, m in meas.items()})
        assert smoke.straddler_dev(dnc, tables, exact, strad) <= 6.0
        assert smoke.straddler_dev(dnc, {c: np.asarray(t) for c, t in
                                         want.items()}, exact, strad) <= 6.0
    c = wk.cliques[strad[0]]
    tables[c] = tables[c] * 1.01
    assert smoke.straddler_dev(dnc, tables, exact, strad) > 6.0


def test_smoke_sigma_gate_equals_the_row_loop_and_catches_a_wrong_table():
    """``chip_smoke.py``'s in-block gate (``sigma_dev``, batched by width
    and cells) gives the per-row max |table - exact| / sigma over the
    in-block and 1-way rows of a forced split, holds a release within 6
    sigma, and puts one in-block table shifted by 7 sigma in one cell
    above 6."""
    import importlib.util
    from pathlib import Path
    from repro_torch.data.tabular import mixture_marginals
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    wk, _ = _mixed_all3(12)
    dnc = select_dnc(wk, 1.0, max_block=4)
    inb = np.flatnonzero(dnc.decomposition.row_block >= 0)
    assert len({len(wk.cliques[r]) for r in inb}) == 4      # widths 0 to 3
    exact = mixture_marginals(wk.domain, list(dict.fromkeys(
        list(dnc.cliques) + list(wk.cliques))), 1e4, 0)
    tables, _ = dnc.engine(**CPU).release(exact, _gen(2))
    sd = np.sqrt(dnc.variances_array())
    want = max(float(np.abs(np.asarray(tables[wk.cliques[r]], np.float64)
                            - exact[wk.cliques[r]]).max()) / sd[r]
               for r in inb)
    index = smoke.width_index(wk.cliques)
    assert smoke.sigma_dev(dnc, tables, exact, inb) == want <= 6.0
    assert smoke.sigma_dev(dnc, tables, exact, inb, index) == want
    r = int(inb[len(inb) // 2])
    c = wk.cliques[r]
    assert len(c) == 2
    tables[c] = np.array(exact[c], np.float64)
    tables[c][1] += 7.0 * sd[r]
    assert smoke.sigma_dev(dnc, tables, exact, inb, index) > 6.0


def test_smoke_background_phase_that_fails_fails_the_smoke(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """``chip_smoke.py`` runs [dnc-d200] in a child process
    (``background_start``); ``background_join`` prints the child's output
    and raises when the child exits non-zero, as it does here without a
    card, so the smoke cannot pass over a phase that did not run."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.chdir(tmp_path)
    started = smoke.background_start("dnc-d200", {"blocks": 7})
    with pytest.raises(AssertionError, match=r"\[dnc-d200\] its child "
                                             r"process exited 2"):
        smoke.background_join(started)
    out = capsys.readouterr().out
    assert "no CUDA device" in out and "[dnc-d200] read " in out
    assert not (tmp_path / "build" / "background" / "dnc-d200.json").exists()


def test_smoke_straddler_check_proxy_and_second_release():
    """``straddler_check``'s one pass gives ``sigma_dev``'s proxy sigma of
    the straddlers and tells a second release's tables apart from the
    first's when one cell moves by one ulp."""
    import importlib.util
    from pathlib import Path
    from repro_torch.data.tabular import mixture_marginals
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    wk, _ = _mixed_all3(12)
    dnc = select_dnc(wk, 1.0, max_block=4)
    strad = np.flatnonzero(dnc.decomposition.row_block == ROW_STRADDLER)
    exact = mixture_marginals(wk.domain, list(dict.fromkeys(
        list(dnc.cliques) + list(wk.cliques))), 1e4, 0)
    eng = dnc.engine(**CPU)
    tables, _ = eng.release(exact, _gen(1))
    again, _ = eng.release(exact, _gen(1))
    got = smoke.straddler_check(dnc, tables, exact, strad, again=again)
    assert got["same"] and got["worst"] <= 6.0
    assert got["worst"] == smoke.straddler_dev(dnc, tables, exact, strad)
    assert got["proxy"] == pytest.approx(
        smoke.sigma_dev(dnc, tables, exact, strad), rel=1e-12)
    c = wk.cliques[strad[-1]]
    again[c] = again[c].copy()
    again[c][0] = np.nextafter(again[c][0], np.inf)
    assert not smoke.straddler_check(dnc, tables, exact, strad,
                                     again=again)["same"]


def test_composite_engine_release_nonneg_and_synthesize():
    wk, _ = _two_component()
    dnc = select_dnc(wk, 50.0)
    recs = synthetic_records(wk.domain, 500, seed=3)
    eng = dnc.engine(**CPU)
    margs = _margs(dnc, recs)
    tables, meas = eng.release(margs, _gen(2), postprocess="nonneg")
    total = float(np.asarray(meas[()].omega).reshape(-1)[0])
    for c in wk.cliques:
        assert (np.asarray(tables[c]) >= 0).all(), c
        assert float(np.sum(tables[c])) == pytest.approx(total, rel=1e-6), c
    synth = eng.synthesize(200, _gen(3))
    assert synth.shape == (200, wk.domain.n_attrs) and (synth >= 0).all()
    assert (synth.max(axis=0) < np.asarray(wk.domain.sizes)).all()
    tables, _ = eng.release(margs, _gen(4), postprocess="consistent")
    assert set(tables) == set(wk.cliques)
    with pytest.raises(ValueError, match="weights"):
        eng.release(margs, _gen(5), postprocess="consistent",
                    weights={(0, 1): 2.0})
    with pytest.raises(ValueError, match="postprocess"):
        eng.release(margs, _gen(5), postprocess="bogus")


def test_composite_engine_shares_empty_measurement():
    wk, _ = _two_component()
    dnc = select_dnc(wk, 2.0)
    recs = synthetic_records(wk.domain, 100, seed=4)
    eng = dnc.engine(**CPU)
    gens = eng.block_generators(_gen(6))
    assert len(gens) == dnc.n_blocks
    meas = eng.measure(_margs(dnc, recs), _gen(6))
    # block 1 measured standalone from its derived generator: its ∅ draw is
    # discarded and block 0's ∅ serves every block
    b1 = eng.block_engines()[1].measure(_margs(dnc, recs), gens[1])
    assert not np.array_equal(b1[()].omega, meas[()].omega)
    for c in dnc.block_plans[1].cliques[1:]:
        assert np.array_equal(b1[c].omega, meas[c].omega), c
    assert eng.variances() == dnc.workload_variances()


# ---------------------------------------------------------------------------
# Engine cache: composite-aware keying
# ---------------------------------------------------------------------------

def test_engine_cache_composite_keying_regression():
    from repro_torch.engine.sharded import _EngineCache

    class _P:
        def __init__(self, children=()):
            self.block_plans = tuple(children)

    f32 = torch.float32
    cache = _EngineCache(maxsize=8)
    kids = [_P(), _P()]
    parent = _P(kids)
    for i, k in enumerate(kids):
        cache.put(k, False, f32, f"kid{i}", device="cpu")
    cache.put(parent, False, f32, "composite", device="cpu")
    assert len(cache) == 3
    assert cache.get(parent, False, f32, device="cpu") == "composite"
    assert cache.get(parent, False, f32, device="cuda") is None   # device key
    parent.block_plans = (kids[0],)
    assert cache.get(parent, False, f32, device="cpu") is None
    parent.block_plans = (kids[0], kids[1])
    cache.put(parent, False, f32, "composite", device="cpu")
    cache._drop_plan(id(kids[1]))
    assert cache.get(kids[0], False, f32, device="cpu") == "kid0"
    assert cache.get(parent, False, f32, device="cpu") is None
    cache.put(parent, False, f32, "composite", device="cpu")
    cache._drop_plan(id(parent))
    assert cache.get(kids[0], False, f32, device="cpu") == "kid0"


def test_engine_for_composite_registers_block_engines():
    from repro_torch.engine.composite import CompositeEngine
    from repro_torch.engine.sharded import _ENGINE_CACHE, _engine_for
    wk, _ = _two_component()
    dnc = select_dnc(wk, 1.0)
    f32 = torch.float32
    eng = _engine_for(dnc, True, f32, device="cpu")
    assert isinstance(eng, CompositeEngine)
    assert _ENGINE_CACHE.get(dnc, True, f32, device="cpu") is eng
    assert _engine_for(dnc, True, f32, device="cpu") is eng
    assert eng.stats.cache_hits >= 2 and eng.stats.cache_misses == 1
    for bp, be in zip(dnc.block_plans, eng.block_engines()):
        assert _ENGINE_CACHE.get(bp, True, f32, device="cpu") is be
    _ENGINE_CACHE._drop_plan(id(dnc))
    assert _ENGINE_CACHE.get(dnc, True, f32, device="cpu") is None
    for bp, be in zip(dnc.block_plans, eng.block_engines()):
        assert _ENGINE_CACHE.get(bp, True, f32, device="cpu") is be


def test_junction_order_equals_the_reference_on_an_all3_workload():
    """The same steps as the JAX package's scan on 14 attributes, all
    <=3-way (455 cliques of three), in its own order and a fixed one."""
    from repro.release.synth import junction_order as j_order
    from repro_torch.release.synth import junction_order
    (wk, jwk) = _mixed_all3(14)
    order = np.random.default_rng(3).permutation(14).tolist()
    for cl, fixed in ((list(wk.cliques), None),
                      (list(wk.cliques)[::-1], order)):
        assert junction_order(wk.domain, cl, fixed) == j_order(
            jwk.domain, cl, fixed)


@pytest.mark.parametrize("seed", range(4))
def test_junction_order_equals_the_reference(seed):
    """The port's vectorized junction order takes the JAX package's steps
    (its per-attribute scan) on random workloads, with and without a fixed
    attribute order; wide composite workloads need it (d = 500)."""
    from repro.release.synth import junction_order as j_order
    from repro_torch.release.synth import junction_order
    rng = np.random.default_rng(seed)
    for _ in range(40):
        d = int(rng.integers(1, 9))
        allc = [c for k in (1, 2, 3) for c in combinations(range(d), k)]
        pick = rng.permutation(len(allc))[:int(rng.integers(1, len(allc) + 1))]
        cl = [allc[j] for j in pick]
        cl += [(a,) for a in range(d) if all(a not in c for c in cl)]
        dom, jdom = Domain.create([2] * d), JDomain.create([2] * d)
        order = None if rng.random() < 0.6 else rng.permutation(d).tolist()
        assert junction_order(dom, cl, order) == j_order(jdom, cl, order)
