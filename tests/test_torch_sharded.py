"""Sharded measurement in the port: the engine cache, sharded marginals
(one process, and two ranks over a gloo process group), sharded_measure
against the plan's engine, and corpus_marginal_release's privacy charge.

Inside the port, sharded measurement equals the engine's ``measure`` on the
same tables and generator seed bit for bit (parity rule 3); against the JAX
package the tables are equal exactly (integer counts) and the charges to
rel 1e-12.  The JAX package is imported inside the tests that compare with
it, so the two-rank workers, spawned from this module, import torch and the
port only.
"""
import gc
import multiprocessing as mp
import random

import numpy as np
import pytest
import torch

from repro_torch.core import (Domain, MarginalWorkload, all_kway,
                              select_sum_of_variances)
from repro_torch.core.accountant import PrivacyBudget
from repro_torch.core.discrete import discrete_pcost_of_plan
from repro_torch.core.mechanism import pcost_of_plan
from repro_torch.data.tabular import marginals_from_records, synthetic_records
from repro_torch.engine import (DiscreteEngine, MarginalEngine, PlusEngine,
                                corpus_marginal_release, sharded_marginals,
                                sharded_measure)
from repro_torch.engine.sharded import (_ENGINE_CACHE, _EngineCache,
                                        _engine_for)

CPU = dict(device="cpu")
F32 = torch.float32


def _plan(sizes=(4, 3, 5, 2), k=3, budget=2.0):
    dom = Domain.create(list(sizes))
    return select_sum_of_variances(all_kway(dom, k, include_lower=True),
                                   budget)


# ---------------------------------------------------------------------------
# _EngineCache
# ---------------------------------------------------------------------------

class _P:
    """Stand-in plan (weakref-able, id-hashable)."""


def test_engine_cache_lru_evicts_one_and_weak_keys_drop():
    cache = _EngineCache(maxsize=3)
    plans = [_P() for _ in range(4)]
    for i, p in enumerate(plans[:3]):
        cache.put(p, False, F32, f"eng{i}", device="cpu")
    assert cache.get(plans[0], False, F32, device="cpu") == "eng0"   # MRU
    cache.put(plans[3], False, F32, "eng3", device="cpu")
    assert len(cache) == 3 and cache.evictions == 1
    assert cache.get(plans[1], False, F32, device="cpu") is None
    assert cache.get(plans[0], False, F32, device="cpu") == "eng0"
    assert cache.get(plans[3], False, F32, device="cpu") == "eng3"
    del plans[3]
    gc.collect()
    assert len(cache) == 2
    assert (cache.hits, cache.misses) == (3, 1)


def test_engine_cache_pins_scores_and_snapshot():
    cache = _EngineCache(maxsize=2)
    a, b, c = _P(), _P(), _P()
    cache.put(a, True, F32, "a", device="cpu")
    cache.put(b, True, F32, "b", device="cpu")
    cache.pin(a, True, F32, device="cpu")
    cache.put(c, True, F32, "c", device="cpu")          # evicts b, not a
    assert cache.get(a, True, F32, device="cpu") == "a"
    assert cache.get(b, True, F32, device="cpu") is None
    cache.pin(c, True, F32, device="cpu")
    d = _P()
    cache.put(d, True, F32, "d", device="cpu")          # all pinned: forced
    assert cache.forced_evictions == 1
    cache.unpin(c, True, F32, device="cpu")
    rows = cache.snapshot()
    assert {r["device"] for r in rows} == {"cpu"}
    assert all(r["dtype"] == "float32" for r in rows)
    cache2 = _EngineCache(maxsize=3)
    e, f, g = _P(), _P(), _P()
    for p, name in ((e, "e"), (f, "f"), (g, "g")):
        cache2.put(p, True, F32, name, device="cpu")
    cache2.evict_score = lambda key: 0.0 if key[0][0] == id(g) else 1.0
    cache2.put(_P(), True, F32, "h", device="cpu")      # lowest score: g
    assert cache2.get(g, True, F32, device="cpu") is None
    assert cache2.get(e, True, F32, device="cpu") == "e"
    with pytest.raises(ValueError):
        _EngineCache(maxsize=0)


@pytest.mark.parametrize("raw,want", [("3", 3), ("0", 1), ("junk", 16),
                                      ("", 16)])
def test_engine_cache_size_from_env(monkeypatch, raw, want):
    monkeypatch.setenv("REPRO_ENGINE_CACHE_SIZE", raw)
    assert _EngineCache().maxsize == want


def test_engine_for_keys_on_secure_digits_device_and_dtype():
    plan = _plan(k=2)
    e4 = _engine_for(plan, True, F32, secure=True, digits=4, **CPU)
    e6 = _engine_for(plan, True, F32, secure=True, digits=6, **CPU)
    assert isinstance(e4, DiscreteEngine) and e4 is not e6
    assert (e4.digits, e6.digits) == (4, 6)
    assert _engine_for(plan, True, F32, secure=True, digits=4, **CPU) is e4
    plain = _engine_for(plan, True, F32, **CPU)
    assert isinstance(plain, MarginalEngine) and plain is not e4
    assert _engine_for(plan, True, torch.float64, **CPU) is not plain
    assert plain.stats.cache_misses == 1


# ---------------------------------------------------------------------------
# sharded_marginals
# ---------------------------------------------------------------------------

def test_sharded_marginals_equal_the_reference_tables():
    import jax.numpy as jnp
    from repro.core import Domain as JDomain
    from repro.engine.sharded import sharded_marginals as j_marginals
    sizes = [5, 3, 4, 2, 6]
    dom = Domain.create(sizes)
    cliques = all_kway(dom, 3, include_lower=True).closure()
    recs = synthetic_records(dom, 1500, seed=8)
    got = sharded_marginals(dom, cliques, recs, **CPU)
    want = j_marginals(JDomain.create(sizes), cliques, jnp.asarray(recs))
    host = marginals_from_records(dom, cliques, recs)
    for c in cliques:
        assert got[c].dtype == np.float64
        assert np.array_equal(got[c], np.asarray(want[c], np.float64)), c
        assert np.array_equal(got[c], host[c]), c
    tens = sharded_marginals(dom, cliques, torch.as_tensor(recs), **CPU)
    assert all(np.array_equal(tens[c], host[c]) for c in cliques)


def test_sharded_marginals_in_several_passes(monkeypatch):
    """Cliques of one width split over bincount passes land in place."""
    import repro_torch.engine.sharded as S
    dom = Domain.create([3, 4, 2, 5, 3])
    cliques = all_kway(dom, 2, include_lower=True).closure()
    recs = synthetic_records(dom, 700, seed=3)
    monkeypatch.setattr(S, "_PASS_ELEMS", 700 * 2 * 3)   # 3 cliques a pass
    got = sharded_marginals(dom, cliques, recs, **CPU)
    host = marginals_from_records(dom, cliques, recs)
    assert all(np.array_equal(got[c], host[c]) for c in cliques)


def _rank_main(rank, store_path, sizes, cliques, recs, out_path):
    """One rank of the two-rank run: its strided shard, summed over gloo."""
    import torch.distributed as dist
    store = dist.FileStore(store_path, 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        tables = sharded_marginals(Domain.create(list(sizes)), cliques,
                                   recs[rank::2], group=dist.group.WORLD,
                                   device="cpu")
        np.savez(f"{out_path}.{rank}.npz",
                 *[tables[c] for c in cliques])
    finally:
        dist.destroy_process_group()


def test_two_rank_gloo_tables_equal_one_process(tmp_path):
    sizes = (4, 3, 5, 2)
    dom = Domain.create(list(sizes))
    cliques = all_kway(dom, 3, include_lower=True).closure()
    recs = synthetic_records(dom, 999, seed=6)
    ctx = mp.get_context("spawn")
    out = str(tmp_path / "tables")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp_path / "store"), sizes, cliques,
                               recs, out)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(5)
    assert not hung, "a gloo rank did not finish within 60 s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    want = sharded_marginals(dom, cliques, recs, **CPU)
    for r in range(2):
        got = np.load(f"{out}.{r}.npz")
        for i, c in enumerate(cliques):
            assert np.array_equal(got[f"arr_{i}"], want[c]), (r, c)


# ---------------------------------------------------------------------------
# sharded_measure == the engine's measure, bit for bit
# ---------------------------------------------------------------------------

def _plus_plan():
    from repro_torch.core.plus import PlusSchema, select_plus
    dom = Domain.create([6, 4, 3], kinds=["numeric", "categorical",
                                          "numeric"])
    wk = all_kway(dom, 2, include_lower=True)
    schema = PlusSchema.create(dom, ["range", "identity", "prefix"], **CPU)
    return select_plus(wk, schema, pcost_budget=1.0, **CPU)


@pytest.mark.parametrize("family", ["plain", "plus", "secure", "dnc"])
def test_sharded_measure_equals_engine_measure(family):
    if family == "plus":
        plan = _plus_plan()
    elif family == "dnc":
        from repro_torch.core import select_dnc
        dom = Domain.create([3, 4, 2, 5])
        plan = select_dnc(MarginalWorkload(
            dom, ((0,), (0, 1), (1, 2), (2, 3), (3,))), 2.0,
            blocks=[[0, 1], [2, 3]])
    else:
        plan = _plan()
    secure = family == "secure"
    recs = synthetic_records(plan.domain, 800, seed=4)

    def gen():
        return random.Random(9) if secure else torch.Generator().manual_seed(9)

    got = sharded_measure(plan, recs, gen(), secure=secure, **CPU)
    eng = plan.engine(secure=secure, **CPU)
    want = eng.measure(marginals_from_records(plan.domain, plan.cliques, recs),
                       gen())
    assert set(got) == set(want) == set(plan.cliques)
    for c in plan.cliques:
        assert np.array_equal(got[c].omega, want[c].omega), c
    cached = _ENGINE_CACHE.get(plan, True, F32, secure, 4, "cpu")
    assert cached is not None and cached.stats.measure_calls == 1
    again = sharded_measure(plan, recs, gen(), secure=secure, **CPU)
    assert all(np.array_equal(again[c].omega, got[c].omega)
               for c in plan.cliques)
    assert cached.stats.cache_hits >= 2
    if family == "plus":
        assert isinstance(cached, PlusEngine)
        with pytest.raises(ValueError):
            sharded_measure(plan, recs, random.Random(0), secure=True, **CPU)


# ---------------------------------------------------------------------------
# corpus_marginal_release
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("secure", [False, True])
def test_corpus_release_charges_as_the_reference(secure):
    import jax
    from repro.core import Domain as JDomain
    from repro.core import MarginalWorkload as JWorkload
    from repro.core.accountant import PrivacyBudget as JBudget
    from repro.engine.corpus_stats import corpus_marginal_release as j_corpus
    sizes, cl = [4, 3, 2], ((0,), (1,), (2,), (0, 1), (1, 2))
    dom = Domain.create(sizes)
    wk = MarginalWorkload(dom, cl)
    recs = synthetic_records(dom, 1200, seed=1)
    budget = PrivacyBudget.from_zcdp(2.0)
    tables, variances, report = corpus_marginal_release(
        dom, wk, recs, budget, 0.5,
        random.Random(1) if secure else torch.Generator().manual_seed(1),
        secure=secure, postprocess="nonneg", **CPU)
    jb = JBudget.from_zcdp(2.0)
    _jt, jvar, jrep = j_corpus(JDomain.create(sizes),
                               JWorkload(JDomain.create(sizes), cl), recs, jb,
                               0.5, jax.random.PRNGKey(1), secure=secure)
    assert report["pcost_spent"] == pytest.approx(jrep["pcost_spent"],
                                                  rel=1e-12)
    assert budget.remaining == pytest.approx(jb.remaining, rel=1e-12)
    plan = select_sum_of_variances(wk, 0.5)
    want = discrete_pcost_of_plan(plan) if secure else pcost_of_plan(plan)
    assert report["pcost_spent"] == pytest.approx(want, rel=1e-12)
    for c in cl:
        assert variances[c] == pytest.approx(jvar[c], rel=1e-12)
        assert (tables[c] >= 0).all()
        assert float(tables[c].sum()) == pytest.approx(
            float(tables[(0,)].sum()), rel=1e-6)
