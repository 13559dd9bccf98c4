"""The port's PlusEngine (Algs 5/6, signature-batched) on the CPU, against the
float64 oracles and the JAX package's PlusEngine on the same measurements.

The engine's noise is replayed into ``measure_plus_np`` through a
``standard_normal`` shim; the JAX engine reconstructs the port's own
measurements.  Tolerance: 1e-4 of max|·| (float32 chains against float64
oracles), the bound tests/test_plus_engine.py holds the JAX engine to.
"""
import math

import numpy as np
import pytest
import torch

from repro.core import Domain as JDomain
from repro.core import MarginalWorkload as JWorkload
from repro.core import plus as jplus
from repro.engine.plus_engine import PlusEngine as JPlusEngine

from repro_torch.convert import plus_plan_arrays, plus_plan_from_arrays
from repro_torch.core import Domain, MarginalWorkload, exact_marginals_from_x
from repro_torch.core.plus import (PlusSchema, measure_plus_np,
                                   reconstruct_plus, select_plus, w_range)
from repro_torch.engine.plus_engine import PlusEngine, expand_range_axis
from repro_torch.kernels.kron_matvec import chain_stats, reset_chain_stats

ATOL = 1e-4


class _ReplayRng:
    """Feeds the engine's noise draws into the numpy oracle, in plan order."""

    def __init__(self, draws, order):
        self._queue = [np.asarray(draws[c], np.float64) for c in order]

    def standard_normal(self, n):
        z = self._queue.pop(0)
        assert z.shape == (n,), (z.shape, n)
        return z


def _jax_plan(sizes, kinds, mode, cliques):
    """The reference's plan (its basis mixes, custom W included)."""
    dom = JDomain.create(list(sizes))
    base_kinds = ["identity" if k == "custom" else k for k in kinds]
    schema = jplus.PlusSchema.create(dom, base_kinds, strategy_mode=mode)
    if "custom" in kinds:
        bases = list(schema.bases)
        for i, kind in enumerate(kinds):
            if kind == "custom":
                n = sizes[i]
                bases[i] = jplus.attr_basis(np.vstack([np.eye(n),
                                                       np.ones((1, n))]))
        schema = jplus.PlusSchema(dom, tuple(bases))
    return jplus.select_plus(JWorkload(dom, tuple(cliques)), schema, 1.0, "sov")


def _default_cliques(n):
    cliques = tuple((i,) for i in range(n))
    if n >= 2:
        cliques += ((0, 1),)
    if n >= 3:
        cliques += ((1, 2), (0, 1, 2))
    return cliques


def _scale(a):
    return max(np.abs(a).max(), 1.0)


def _engine_vs_oracles(sizes, kinds, mode, use_kernel=True, cliques=None):
    cliques = _default_cliques(len(sizes)) if cliques is None else cliques
    jplan = _jax_plan(sizes, kinds, mode, cliques)
    plan = plus_plan_from_arrays(*plus_plan_arrays(jplan))
    x = np.random.default_rng(0).integers(0, 7, plan.domain.universe_size())
    margs = exact_marginals_from_x(plan.domain, plan.cliques, x.astype(float))
    eng = PlusEngine(plan, use_kernel=use_kernel, device="cpu")
    meas = eng.measure(margs, torch.Generator().manual_seed(7))
    draws = eng.noise_draws(torch.Generator().manual_seed(7))
    oracle = measure_plus_np(plan, margs, _ReplayRng(draws, plan.cliques))
    for c in plan.cliques:
        assert meas[c].sigma2 == plan.sigma2(c)
        err = np.abs(meas[c].omega - oracle[c].omega).max()
        assert err / _scale(oracle[c].omega) < ATOL, c
    tables = eng.reconstruct(meas)
    jtables = JPlusEngine(jplan, use_kernel=False,
                          precompile=False).reconstruct(meas)
    for c in plan.workload.cliques:
        want = reconstruct_plus(plan, oracle, c)
        assert tables[c].shape == want.shape == (plan.schema.query_rows(c),)
        assert np.abs(tables[c] - want).max() / _scale(want) < ATOL, c
        assert np.abs(tables[c] - jtables[c]).max() / _scale(want) < ATOL, c
    return plan, eng


@pytest.mark.parametrize("use_kernel", [True, False])
def test_plus_engine_mixed_workload_matches_oracles(use_kernel):
    _engine_vs_oracles([4, 3, 5], ["prefix", "identity", "range"], "hier",
                       use_kernel, cliques=((0,), (0, 2), (1, 2), (0, 1, 2), ()))


@pytest.mark.parametrize("kinds,mode", [
    (["range", "range", "range"], "hier"),       # all-general: no stage B
    (["identity", "identity", "identity"], "w"),  # all-identity: one chain
    (["identity", "prefix", "custom"], "w"),
    (["custom", "range", "identity"], "hier"),
])
def test_plus_engine_basis_mixes(kinds, mode):
    _engine_vs_oracles([3, 4, 2], kinds, mode)


def test_plus_engine_odd_sizes_and_empty_clique():
    plan, _ = _engine_vs_oracles([7, 2, 5], ["range", "identity", "prefix"],
                                 "hier", cliques=((), (0,), (2,), (0, 2), (0, 1)))
    assert () in plan.cliques


def test_plus_engine_auto_strategy_and_fallback_route():
    """p-Identity strategies (the paper's §9 prefix setting) and a chain too
    wide for the fused kernel: its epilogue runs after the per-axis path."""
    reset_chain_stats()
    plan, eng = _engine_vs_oracles([40, 40, 40, 3],
                                   ["prefix", "prefix", "identity", "identity"],
                                   "auto", cliques=((0, 1, 2), (1, 3), (0,)))
    st = chain_stats()
    assert eng.stats.fallback_chains > 0 and st["fallback_chains"] > 0
    assert st["epilogue_axes"] > 0
    assert any(r["epilogue"] != (None,) * len(r["dims"]) and not r["fused"]
               for r in eng.chain_plans())


def test_range_expansion_matches_dense_w(rng):
    for n in (2, 3, 6, 9):
        x = rng.standard_normal((4, n, 3))
        p = torch.as_tensor(np.cumsum(x, axis=1))
        got = expand_range_axis(p, 1, n).numpy()
        want = np.einsum("rn,bnk->brk", w_range(n), x)
        assert got.shape == (4, n * (n + 1) // 2, 3)
        assert np.allclose(got, want, rtol=1e-12, atol=1e-12), n


def test_plus_engine_chain_plans_and_counts():
    """One chain per planned group stage; reconstruct chains carry their
    epilogue; every epilogue axis is counted."""
    dom = Domain.create([3, 3, 3])
    wk = MarginalWorkload(dom, ((0, 1), (1, 2), (0, 2)))
    schema = PlusSchema.create(dom, ["range"] * 3, strategy_mode="hier",
                               device="cpu")
    plan = select_plus(wk, schema, 1.0, "sov", device="cpu")
    margs = {c: np.arange(dom.n_cells(c), dtype=float) for c in plan.cliques}
    eng = PlusEngine(plan, device="cpu")
    assert eng.stats.compile_warmups == 0           # nothing to build on a CPU
    reset_chain_stats()
    tables, meas = eng.release(margs, torch.Generator().manual_seed(0))
    st = chain_stats()
    # measure: all-general bases, stage A only, one chain per non-empty
    # group (arity 1 and 2); reconstruct: one merged chain for the pairs
    assert st["fused_chains"] == 3 and st["fallback_chains"] == 0
    assert st["epilogue_axes"] == 2 and st["fused_launches"] == 0
    rows = eng.chain_plans()
    assert len(rows) == eng.stats.fused_chains == 3
    assert [r["epilogue"] for r in rows].count(("cumsum", "cumsum")) == 1
    assert all(t.shape == (36,) for t in tables.values())


def test_plus_engine_postprocess_checks():
    dom = Domain.create([3, 4])
    wk = MarginalWorkload(dom, ((0, 1),))
    margs = {c: np.ones(dom.n_cells(c)) for c in [(), (0,), (1,), (0, 1)]}
    for kinds, err in ((["prefix", "identity"], ValueError),
                       (["identity", "identity"], None)):
        schema = PlusSchema.create(dom, kinds, strategy_mode="w", device="cpu")
        eng = select_plus(wk, schema, 1.0, device="cpu").engine(device="cpu")
        if err is None:     # identity bases: the tables are marginals
            tables, _ = eng.release(margs, torch.Generator(),
                                    postprocess="consistent")
            assert set(tables) == {(0, 1)}
            assert eng.stats.postprocess_calls == 1
            continue
        with pytest.raises(err):
            eng.release(margs, torch.Generator(), postprocess="consistent")
    with pytest.raises(ValueError, match="secure"):
        select_plus(wk, schema, 1.0, device="cpu").engine(secure=True)


def test_plus_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    dom = Domain.create([3, 4])
    schema = PlusSchema.create(dom, ["prefix", "range"], strategy_mode="w",
                               device="cpu")
    plan = select_plus(MarginalWorkload(dom, ((0, 1),)), schema, 1.0,
                       device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PlusEngine(plan)
    with pytest.raises(RuntimeError, match="CUDA"):
        plan.engine()


def test_plus_engine_float64_noise_and_bad_marginal():
    dom = Domain.create([3, 4])
    schema = PlusSchema.create(dom, ["prefix", "identity"], strategy_mode="hier",
                               device="cpu")
    plan = select_plus(MarginalWorkload(dom, ((0, 1),)), schema, 1.0,
                       device="cpu")
    margs = {c: np.ones(dom.n_cells(c)) for c in plan.cliques}
    eng = PlusEngine(plan, dtype=torch.float64, device="cpu")
    meas = eng.measure(margs, torch.Generator().manual_seed(1))
    draws = eng.noise_draws(torch.Generator().manual_seed(1))
    oracle = measure_plus_np(plan, margs, _ReplayRng(draws, plan.cliques))
    for c in plan.cliques:
        assert np.allclose(meas[c].omega, oracle[c].omega, rtol=1e-6, atol=1e-6)
    margs[(0, 1)] = np.ones(5)
    with pytest.raises(ValueError, match="cells"):
        eng.measure(margs, torch.Generator())
    with pytest.raises(TypeError):
        PlusEngine(plan, dtype=torch.float16, device="cpu")
