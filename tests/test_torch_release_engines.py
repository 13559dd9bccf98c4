"""The release surface of the port's three engines, on the CPU.

``release(postprocess=...)`` / ``synthesize`` on MarginalEngine, PlusEngine
(identity bases only) and the secure DiscreteEngine (integer-exact totals),
each held against the JAX package's ``postprocess_release`` on the same raw
tables: the engine's own raw release from the same seed (atol 5e-5 of the
largest table, both CGs in float32).
"""
import numpy as np
import pytest
import torch

from repro.core import Domain as JDomain
from repro.core import all_kway as j_all_kway
from repro.core import select as j_select
import repro.release as J

from repro_torch.convert import plan_arrays, plan_from_arrays
from repro_torch.core import Domain, all_kway
from repro_torch.core.plus import PlusSchema, select_plus
from repro_torch.data.tabular import marginals_from_records, synthetic_records
from repro_torch.release import synth_report

ATOL = 5e-5    # of the largest table


@pytest.fixture
def small():
    jplan = j_select(j_all_kway(JDomain.create([4, 3, 5, 2]), 2,
                                include_lower=True), pcost_budget=1.0)
    plan = plan_from_arrays(*plan_arrays(jplan))
    records = synthetic_records(plan.domain, 5000, seed=0)
    margs = marginals_from_records(plan.domain, plan.cliques, records)
    return jplan, plan, records, margs


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _close_family(got, want):
    scale = max(max(float(np.abs(t).max()) for t in want.values()), 1.0)
    for c, t in want.items():
        assert float(np.abs(got[c] - t).max()) <= ATOL * scale, c


@pytest.mark.parametrize("mode", ["consistent", "nonneg"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_marginal_engine_postprocess_equals_reference(small, mode, use_kernel):
    jplan, plan, _records, margs = small
    eng = plan.engine(use_kernel=use_kernel, device="cpu")
    raw, _ = eng.release(margs, _gen(0))
    tables, _ = eng.release(margs, _gen(0), postprocess=mode)
    assert eng.stats.postprocess_calls == 1
    _close_family(tables, J.postprocess_release(jplan, raw, mode))
    m01 = tables[(0, 1)].reshape(4, 3)
    m12 = tables[(1, 2)].reshape(3, 5)
    if mode == "consistent":   # shared sub-marginals agree
        np.testing.assert_allclose(m01.sum(axis=0), m12.sum(axis=1),
                                   atol=1e-3)
        return
    total = float(tables[plan.workload.cliques[0]].sum())
    for c in plan.workload.cliques:
        assert np.all(tables[c] >= 0)
        assert abs(tables[c].sum() - total) <= 1e-6 * max(total, 1.0)
    # the projection is local: consistent within a few counts only
    assert np.abs(m01.sum(axis=0) - m12.sum(axis=1)).max() < 50


def test_marginal_engine_release_options_and_repeatability(small):
    jplan, plan, _records, margs = small
    eng = plan.engine(device="cpu")
    raw, _ = eng.release(margs, _gen(2))
    kw = dict(total=5000.0, weights=np.linspace(1.0, 2.0, len(raw)),
              mw_rounds=1)
    a, _ = eng.release(margs, _gen(2), postprocess="nonneg", **kw)
    b, _ = eng.release(margs, _gen(2), postprocess="nonneg", **kw)
    for c in a:
        assert np.array_equal(a[c], b[c])           # one seed, one release
        assert round(float(a[c].sum())) == 5000
    _close_family(a, J.postprocess_release(jplan, raw, "nonneg", **kw))
    host, _ = eng.release(margs, _gen(2), postprocess="consistent",
                          backend="host")
    _close_family(host, J.postprocess_release(jplan, raw, "consistent",
                                              backend="host"))
    with pytest.raises(ValueError, match="postprocess mode"):
        eng.release(margs, _gen(2), postprocess="fancy")
    assert eng.stats.measure_calls == 4            # the bad mode measured nothing


def test_marginal_engine_synthesize(small):
    _jplan, plan, _records, margs = small
    eng = plan.engine(device="cpu")
    with pytest.raises(ValueError):
        eng.synthesize(100, _gen(0))               # no nonneg release yet
    nn, _ = eng.release(margs, _gen(0), postprocess="nonneg")
    recs = eng.synthesize(20_000, _gen(1))
    assert recs.shape == (20_000, plan.domain.n_attrs) and recs.dtype == np.int32
    for i, a in enumerate(plan.domain.attributes):
        assert recs[:, i].min() >= 0 and recs[:, i].max() < a.size
    assert eng.stats.synthesize_calls == 1
    assert np.array_equal(recs, eng.synthesize(20_000, _gen(1)))
    again = eng.synthesize(20_000, _gen(1), tables=nn, batch=4096)
    assert np.array_equal(recs, again)
    assert synth_report(plan.domain, nn, recs).max_tv < 0.05


def test_raw_release_unchanged(small):
    """postprocess=None keeps the unbiased (tables, meas) output."""
    _jplan, plan, _records, margs = small
    eng = plan.engine(device="cpu")
    t1, _m1 = eng.release(margs, _gen(0))
    t2 = eng.reconstruct(eng.measure(margs, _gen(0)))
    for c in plan.workload.cliques:
        assert np.array_equal(t1[c], t2[c])
    assert eng.stats.postprocess_calls == 0


def test_discrete_engine_integer_exact_totals(small):
    jplan, plan, _records, margs = small
    eng = plan.engine(secure=True, device="cpu")
    raw, meas_raw = eng.release(margs, _gen(3))
    tables, meas = eng.release(margs, _gen(3), postprocess="nonneg")
    measured = float(np.asarray(meas[()].omega).reshape(-1)[0])
    assert measured.is_integer()
    assert measured == float(np.asarray(meas_raw[()].omega).reshape(-1)[0])
    for c in plan.workload.cliques:
        assert np.all(tables[c] >= 0)
        assert round(float(tables[c].sum())) == int(measured)
    _close_family(tables, J.postprocess_release(
        jplan, raw, "nonneg", total=J.measured_integer_total(meas)))
    cons, _ = eng.release(margs, _gen(3), postprocess="consistent")
    for c in plan.workload.cliques:
        assert abs(float(cons[c].sum()) - measured) <= 1e-6 * abs(measured)
    recs = eng.synthesize(5000, _gen(4))
    assert recs.shape == (5000, plan.domain.n_attrs)
    assert eng.stats.postprocess_calls == 2 and eng.stats.synthesize_calls == 1


@pytest.mark.parametrize("mode", ["consistent", "nonneg"])
def test_plus_engine_identity_postprocess(small, mode):
    _jplan, plan, records, _margs = small
    dom = plan.domain
    wk = all_kway(dom, 2, include_lower=True)
    schema = PlusSchema.create(dom, ["identity"] * dom.n_attrs, device="cpu")
    pplan = select_plus(wk, schema, pcost_budget=1.0, device="cpu")
    margs = marginals_from_records(dom, pplan.cliques, records)
    eng = pplan.engine(device="cpu")
    raw, _ = eng.release(margs, _gen(0))
    tables, _ = eng.release(margs, _gen(0), postprocess=mode)
    # the JAX package's postprocess of the same raw tables under the same
    # plan (its plain-marginal twin: identity bases are marginals)
    jplan = j_select(j_all_kway(JDomain.create(list(dom.sizes)), 2,
                                include_lower=True), pcost_budget=1.0)
    weights = J.precision_weights(pplan)
    _close_family(tables, J.postprocess_release(jplan, raw, mode,
                                                weights=weights))
    if mode == "nonneg":
        total = float(tables[wk.cliques[0]].sum())
        for c in wk.cliques:
            assert np.all(tables[c] >= 0)
            assert abs(tables[c].sum() - total) <= 1e-4 * max(total, 1.0)
        recs = eng.synthesize(2000, _gen(1))
        assert recs.shape == (2000, dom.n_attrs)


@pytest.mark.parametrize("mode", ["consistent", "nonneg"])
def test_plus_engine_non_identity_rejected(mode):
    dom = Domain.create([8, 3], kinds=["numeric", "categorical"])
    wk = all_kway(dom, 2, include_lower=True)
    schema = PlusSchema.create(dom, ["range", "identity"],
                               strategy_mode="hier", device="cpu")
    pplan = select_plus(wk, schema, pcost_budget=1.0, device="cpu")
    records = synthetic_records(dom, 1000, seed=1)
    margs = marginals_from_records(dom, pplan.cliques, records)
    eng = pplan.engine(device="cpu")
    with pytest.raises(ValueError, match="identity-basis"):
        eng.release(margs, _gen(0), postprocess=mode)
    assert eng.stats.measure_calls == 0            # rejected before measuring
