"""The port's ResidualPlanner+ planner (core/plus.py, baselines/hdmm.py,
configs/synth_ranges.py, convert) against the JAX package on the CPU.

Inputs come from numpy with a seed.  The host numpy parts are copies of the
reference and must agree to 1e-12 (the same LAPACK calls on the same
inputs); the SoV closed form to rel 1e-9; the float32 Adam loops, which take
their sums in another order than XLA, to the tolerances stated at each test.
"""
import math

import numpy as np
import pytest
import torch

import jax

from repro.baselines.hdmm import opt_pidentity as jax_opt_pidentity
from repro.core import Domain as JDomain
from repro.core import MarginalWorkload as JWorkload
from repro.core import all_kway as jax_all_kway
from repro.core import plus as jplus

from repro_torch.baselines import hdmm
from repro_torch.configs import synth_ranges
from repro_torch.convert import plus_plan_arrays, plus_plan_from_arrays
from repro_torch.core import Domain, all_kway
from repro_torch.core import plus

TIGHT = 1e-12


def _schemas(sizes, kinds, mode):
    jschema = jplus.PlusSchema.create(JDomain.create(sizes), kinds,
                                      strategy_mode=mode)
    schema = plus.PlusSchema.create(Domain.create(sizes), kinds,
                                    strategy_mode=mode, device="cpu")
    return jschema, schema


def _close(a, b, tol=TIGHT):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b), initial=0.0) <= tol * max(np.abs(b).max(initial=0.0), 1.0)


@pytest.mark.parametrize("mode", ["w", "hier"])
@pytest.mark.parametrize("kind", ["identity", "prefix", "range"])
def test_bases_match_jax(kind, mode):
    jschema, schema = _schemas([7, 2, 12], [kind, kind, "identity"], mode)
    for jb, b in zip(jschema.bases, schema.bases):
        assert (b.kind, b.identity, b.n) == (jb.kind, jb.identity, jb.n)
        for name in ("W", "S", "Sub", "Gamma", "sub_pinv"):
            _close(getattr(b, name), getattr(jb, name))
        for name in ("beta", "fnorm2", "wones2"):
            assert getattr(b, name) == pytest.approx(getattr(jb, name),
                                                     rel=TIGHT, abs=TIGHT)
        assert plus.plus_axis_token(b) == jplus.plus_axis_token(jb)


def test_w_matrices_and_classify_match_jax():
    for n in (2, 5, 9):
        for kind in ("identity", "prefix", "range", "total"):
            W = plus.build_w(kind, n)
            assert np.array_equal(W, jplus.build_w(kind, n))
            assert plus.classify_w(W) == jplus.classify_w(W) == kind
        assert np.array_equal(plus.s_hierarchical(n), jplus.s_hierarchical(n))
    assert plus.classify_w(np.vstack([np.eye(3), np.ones((1, 3))])) == "custom"


def _workload_pair(sizes, k):
    return (jax_all_kway(JDomain.create(sizes), k, include_lower=True),
            all_kway(Domain.create(sizes), k, include_lower=True))


@pytest.mark.parametrize("sizes,kinds,mode", [
    ([4, 3, 5, 2], ["prefix", "identity", "range", "range"], "hier"),
    ([6, 6, 3], ["range", "range", "prefix"], "w"),
])
def test_select_plus_sov_matches_jax(sizes, kinds, mode):
    jschema, schema = _schemas(sizes, kinds, mode)
    jwk, wk = _workload_pair(sizes, 3)
    jplan = jplus.select_plus(jwk, jschema, 2.0, "sov")
    plan = plus.select_plus(wk, schema, 2.0, "sov", device="cpu")
    assert plan.cliques == jplan.cliques
    assert np.allclose(plan.sigma, jplan.sigma, rtol=1e-9, atol=0)
    assert plan.loss_value == pytest.approx(jplan.loss_value, rel=1e-9)
    assert plan.pcost == pytest.approx(jplan.pcost, rel=1e-9)
    assert plan.rmse() == pytest.approx(jplan.rmse(), rel=1e-9)
    for c in wk.cliques:
        _close(plus.cell_variances_plus(schema, plan.sigmas, c),
               jplus.cell_variances_plus(jschema, jplan.sigmas, c), 1e-9)


def test_select_plus_max_variance_matches_jax():
    """d = 2; float32 Adam on both sides, sums in another order: rel 1e-3.

    At the default lr = 0.05 the last iterates of either package wander by
    about ±0.2% around the optimum (seen across step counts), so the two
    are compared at lr = 0.01, where each settles."""
    sizes, kinds = [4, 4], ["range", "range"]
    jschema, schema = _schemas(sizes, kinds, "hier")
    jwk, wk = _workload_pair(sizes, 2)
    jplan = jplus.select_plus(jwk, jschema, 1.0, "max_variance", steps=3000,
                              lr=0.01)
    plan = plus.select_plus(wk, schema, 1.0, "max_variance", steps=3000,
                            lr=0.01, device="cpu")
    assert plan.loss_value == pytest.approx(jplan.loss_value, rel=1e-3)
    assert plan.pcost == pytest.approx(1.0, rel=1e-9)
    assert plan.max_cell_variance() == pytest.approx(plan.loss_value, rel=1e-12)
    sov = plus.select_plus(wk, schema, 1.0, "sov", device="cpu")
    assert plan.loss_value <= sov.max_cell_variance() * (1 + 1e-6)


def _trace_objective(A, W):
    M = A.T @ A + 1e-9 * np.eye(A.shape[1])
    return float(np.trace(np.linalg.solve(M, W.T @ W)))


@pytest.mark.parametrize("kind,n,seed", [("prefix", 8, 0), ("range", 6, 3),
                                         ("prefix", 20, 1)])
def test_opt_pidentity_adam_matches_jax(kind, n, seed):
    """The Adam loop fed JAX's own θ₀: trace objective rel 1e-4, A atol 1e-3
    (float32 solves on both sides)."""
    W = plus.build_w(kind, n)
    P1 = W - W.sum(axis=1, keepdims=True) / n
    iters = 400
    want = jax_opt_pidentity(P1, iters=iters, seed=seed)
    p = max(1, n // 16 + 1)
    theta0 = np.array(jax.random.normal(jax.random.PRNGKey(seed), (p, n))
                       * 0.5 - 1.0)
    theta = hdmm._adam_pidentity(torch.as_tensor(P1.T @ P1, dtype=torch.float32),
                                 torch.as_tensor(theta0), iters, 0.05)
    got = hdmm._make_a(theta).numpy().astype(np.float64)
    assert got.shape == want.shape == (n + p, n)
    assert _trace_objective(got, P1) == pytest.approx(
        _trace_objective(want, P1), rel=1e-4)
    assert np.abs(got - want).max() <= 1e-3


def test_opt_pidentity_memo_and_unit_columns():
    W = plus.build_w("prefix", 9)
    a = hdmm.opt_pidentity_projected(W, iters=50, seed=5, device="cpu")
    b = hdmm.opt_pidentity_projected(W, iters=50, seed=5, device="cpu")
    assert a is b                                           # memo hit
    assert np.allclose(np.linalg.norm(a, axis=0), 1.0, atol=1e-6)
    assert a.shape == (9 + 1, 9) and np.all(a[9:] >= 0)
    assert np.array_equal(hdmm.opt_pidentity(np.ones((2, 1)), device="cpu"),
                          np.ones((1, 1)))


def test_auto_schema_uses_the_optimizer():
    sizes = [10, 3]
    schema = plus.PlusSchema.create(Domain.create(sizes), ["prefix", "identity"],
                                    strategy_mode="auto", device="cpu")
    S = hdmm.opt_pidentity_projected(plus.build_w("prefix", 10), device="cpu")
    assert schema.bases[0].S is S and schema.bases[1].identity


def test_convert_carries_a_jax_plan_across():
    sizes, kinds = [4, 3, 5], ["prefix", "identity", "range"]
    jschema = jplus.PlusSchema.create(JDomain.create(sizes), kinds,
                                      strategy_mode="auto")
    jwk = JWorkload(jschema.domain, ((0,), (0, 2), (1, 2), (0, 1, 2)),
                    {(0, 2): 3.0})
    jplan = jplus.select_plus(jwk, jschema, 1.0, "sov")
    plan = plus_plan_from_arrays(*plus_plan_arrays(jplan))
    assert plan.cliques == jplan.cliques and plan.objective == "sov"
    assert np.array_equal(plan.sigma, jplan.sigma)
    assert plan.loss_value == pytest.approx(jplan.loss_value, rel=1e-12)
    for jb, b in zip(jschema.bases, plan.schema.bases):
        _close(b.Sub, jb.Sub)
        _close(b.S, jb.S)
    args = list(plus_plan_arrays(jplan))
    args[5] = args[5][:-1]
    with pytest.raises(ValueError):
        plus_plan_from_arrays(*args)


def test_oracles_and_chain_helpers_match_jax(rng):
    sizes, kinds = [4, 3, 5], ["prefix", "identity", "range"]
    jschema, schema = _schemas(sizes, kinds, "hier")
    jwk, wk = _workload_pair(sizes, 3)
    jplan = jplus.select_plus(jwk, jschema, 1.0, "sov")
    plan = plus.select_plus(wk, schema, 1.0, "sov", device="cpu")
    margs = {c: rng.integers(0, 9, math.prod(sizes[i] for i in c)).astype(float)
             for c in plan.cliques}
    meas = plus.measure_plus_np(plan, margs, np.random.default_rng(4))
    jmeas = jplus.measure_plus_np(jplan, margs, np.random.default_rng(4))
    for c in plan.cliques:
        _close(meas[c].omega, jmeas[c].omega)
    for c in wk.cliques:
        want = jplus.reconstruct_plus(jplan, jmeas, c)
        _close(plus.reconstruct_plus(plan, meas, c), want)
        _close(plus.reconstruct_plus_merged(plan, meas, c), want, 1e-9)
        dims, zdims, a, b = plus.measure_chain_split(schema, c)
        jdims, jzdims, ja, jb = jplus.measure_chain_split(jschema, c)
        assert (dims, zdims) == (jdims, jzdims)
        for f, jf in zip(a + b, ja + jb):
            assert (f is None) == (jf is None)
            if f is not None:
                _close(f, jf)
        for f, jf in zip(plus.t_chain_factors_plus(schema, c),
                         jplus.t_chain_factors_plus(jschema, c)):
            _close(f, jf)
    groups = plus.plus_signature_groups(schema, plan.cliques)
    jgroups = jplus.plus_signature_groups(jschema, jplan.cliques)
    assert list(groups.values()) == list(jgroups.values())


def test_synth_ranges_make_matches_jax():
    from repro.configs.synth_ranges import make as jax_make
    dom, wk, schema = synth_ranges.make(n=6, d=5, device="cpu")
    jdom, jwk, jschema = jax_make(n=6, d=5)
    assert dom.sizes == jdom.sizes and wk.cliques == jwk.cliques
    assert all(a.kind == "numeric" for a in dom.attributes)
    for jb, b in zip(jschema.bases, schema.bases):
        _close(b.Sub, jb.Sub)


def test_planner_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    dom = Domain.create([4, 3])
    with pytest.raises(RuntimeError, match="CUDA"):
        plus.PlusSchema.create(dom, ["prefix", "identity"], strategy_mode="hier")
    with pytest.raises(RuntimeError, match="CUDA"):
        hdmm.opt_pidentity(plus.build_w("prefix", 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        synth_ranges.make(n=4, d=3)
    schema = plus.PlusSchema.create(dom, ["prefix", "identity"],
                                    strategy_mode="hier", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        plus.select_plus(all_kway(dom, 2), schema, 1.0, "sov")
