"""The port's DiscreteEngine (secure release, Algorithm 3) against the JAX
package's and against the host-exact oracle ``measure_discrete``.

The engines run on the CPU here (``device="cpu"``: the kernels' plain
versions at float32).  H is exact on every tier, so each tier's Ξx = Hv must
equal the JAX engine's and the int64 host chain's integer for integer.  Y†
and the reconstruction are float32 chains on both sides: held within rel
1e-5 of each group's largest value.
"""
import random
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.core import Domain as JDomain
from repro.core import all_kway as jax_all_kway
from repro.core import select_sum_of_variances as jax_sov
from repro.engine import DiscreteEngine as JDiscreteEngine

from repro_torch.convert import plan_arrays, plan_from_arrays
from repro_torch.core import (Domain, MarginalWorkload, all_kway,
                              exact_marginals_from_x, select_sum_of_variances)
from repro_torch.core.discrete import (DiscreteMeasurement, clique_gamma2,
                                       discrete_pcost_of_plan, h_factors,
                                       measure_discrete)
from repro_torch.core.kron import kron_matvec_np_batched
from repro_torch.engine import DiscreteEngine
from repro_torch.engine.discrete_engine import as_np_rng
from repro_torch.kernels.kron_matvec import chain_stats, reset_chain_stats

REL = 1e-5    # float32 Y† / U chains against float32 (JAX) or float64 oracles

_ZERO = lambda g2, n, r: np.zeros(n, dtype=object)        # noqa: E731


def _fixed_noise(g2, n, _r):
    """Deterministic integer 'noise' fed to both engines alike."""
    return (np.arange(n, dtype=np.int64) * 7919) % 41 - 20


def _plans(sizes, k=2):
    ref = jax_sov(jax_all_kway(JDomain.create(sizes), k, include_lower=True),
                  1.0)
    return ref, plan_from_arrays(*plan_arrays(ref))


def _margs(plan, hi, seed=0):
    x = np.random.default_rng(seed).integers(
        0, hi, plan.domain.universe_size()).astype(float)
    return exact_marginals_from_x(plan.domain, plan.cliques, x)


def _single(sizes, hi, seed=2):
    dom = Domain.create(sizes)
    plan = select_sum_of_variances(MarginalWorkload(dom, (tuple(range(len(sizes))),)),
                                   1.0)
    return plan, _margs(plan, hi, seed)


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) <= REL * scale


def test_engine_via_plan_protocol_and_chain_roles():
    _ref, plan = _plans([4, 3, 2])
    eng = plan.engine(secure=True, device="cpu")
    assert isinstance(eng, DiscreteEngine) and eng.digits == 4
    assert plan.engine(secure=True, digits=6, device="cpu").digits == 6
    rows = eng.chain_plans()
    groups = [d for d in eng._groups if d]
    recon = [d for d in eng._reconstruct_groups if d]
    # an H and a Y† chain per measure group, a U chain per workload group
    assert sum(r["role"] == "measure" for r in rows) == 2 * len(groups)
    assert sum(r["role"] == "reconstruct" for r in rows) == len(recon)
    tables, meas = eng.release(_margs(plan, 9), torch.Generator(),
                               postprocess="nonneg")
    total = float(meas[()].omega.reshape(-1)[0])
    assert eng.stats.postprocess_calls == 1 and total.is_integer()
    assert all(np.all(t >= 0) and round(float(t.sum())) == int(total)
               for t in tables.values())


@pytest.mark.parametrize("hi,tier", [(30, "device_h_groups"),
                                     (10 ** 6, "exact_h_groups")])
def test_h_transform_tiers_equal_jax_exactly(hi, tier):
    """Device tier (rint of the float32 chain) and int64 tier: the port's H
    equals the JAX engine's, integer for integer, and the int64 oracle."""
    ref, plan = _plans([5, 4, 3], k=3)
    margs = _margs(plan, hi)
    mine = DiscreteEngine(plan, device="cpu")
    theirs = JDiscreteEngine(ref, use_kernel=False, precompile=False)
    for dims, cl in mine._groups.items():
        if not dims:
            continue
        vs = np.stack([np.asarray(margs[c], np.float64) for c in cl])
        got = mine._h_transform(vs, dims)
        want = theirs._h_transform(vs, dims)
        oracle = kron_matvec_np_batched(h_factors(dims, np.int64),
                                        np.rint(vs).astype(np.int64), dims)
        assert got.dtype == want.dtype == np.int64
        assert np.array_equal(got, want) and np.array_equal(got, oracle), dims
    assert getattr(mine.stats, tier) > 0
    assert getattr(theirs.stats, tier) == getattr(mine.stats, tier)


def test_h_transform_big_int_tier_equals_jax_exactly():
    """Counts past the int64 bound take Python big-int lanes on both sides."""
    ref, plan = _plans([4, 3, 2])
    mine = DiscreteEngine(plan, device="cpu")
    theirs = JDiscreteEngine(ref, use_kernel=False, precompile=False)
    dims = (4, 3, 2)
    vs = np.random.default_rng(0).integers(0, 10 ** 6, (2, 24)).astype(float)
    vs *= 1e12                                  # ‖v‖₁·Π2n·max n ≥ 2^62
    got = mine._h_transform(vs, dims)
    want = theirs._h_transform(vs, dims)
    assert got.dtype == want.dtype == object
    assert np.array_equal(got, want)
    assert mine.stats.exact_h_groups == 1 and mine.stats.device_h_groups == 0


def test_h_bound_edge_on_the_exact_side():
    """‖v‖₁ = ⌊(2^24−1)/4000⌋ on (10, 10) sits just below the float32 bound
    (‖v‖₁·400·10 < 2^24): device tier, equal to int64 H; one count more
    goes to the int64 tier."""
    _ref, plan = _plans([10, 10])
    eng = DiscreteEngine(plan, device="cpu")
    dims = (10, 10)
    l1 = (2 ** 24 - 1) // 4000
    vs = np.zeros((1, 100))
    vs[0, 37] = l1
    got = eng._h_transform(vs, dims)
    want = kron_matvec_np_batched(h_factors(dims, np.int64),
                                  vs.astype(np.int64), dims)
    assert eng.stats.device_h_groups == 1 and np.array_equal(got, want)
    vs[0, 37] = l1 + 1
    eng._h_transform(vs, dims)
    assert eng.stats.exact_h_groups == 1


def test_float64_plain_chain_uses_the_53_bit_bound():
    plan, margs = _single([10, 10, 10], 10 ** 6)
    e32 = DiscreteEngine(plan, device="cpu")
    e64 = DiscreteEngine(plan, device="cpu", use_kernel=False,
                         dtype=torch.float64)
    m32 = e32.measure(margs, torch.Generator().manual_seed(0),
                      _noise_override=_ZERO)
    m64 = e64.measure(margs, torch.Generator().manual_seed(0),
                      _noise_override=_ZERO)
    # ‖v‖₁ ≈ 5e8: every group past 2^24 (float32), all below 2^53 (float64)
    assert e32.stats.exact_h_groups == 3 and e32.stats.device_h_groups == 0
    assert e64.stats.exact_h_groups == 0 and e64.stats.device_h_groups == 3
    for c in plan.cliques:
        assert _close(m32[c].omega, m64[c].omega), c


def test_omega_and_tables_match_jax_engine():
    """The same deterministic integer noise through both engines: Ω and the
    reconstructed tables agree to float32 precision."""
    ref, plan = _plans([5, 4, 3, 2], k=3)
    margs = _margs(plan, 20)
    mine = DiscreteEngine(plan, device="cpu")
    theirs = JDiscreteEngine(ref, use_kernel=False, precompile=False)
    a = mine.measure(margs, torch.Generator().manual_seed(0),
                     _noise_override=_fixed_noise)
    b = theirs.measure(margs, jax.random.PRNGKey(0),
                       _noise_override=_fixed_noise)
    for c in ref.cliques:
        assert isinstance(a[c], DiscreteMeasurement)
        assert a[c].sigma_bar == b[c].sigma_bar and a[c].gamma2 == b[c].gamma2
        assert _close(a[c].omega, b[c].omega), c
    ta, tb = mine.reconstruct(a), theirs.reconstruct(b)
    for c in ref.workload.cliques:
        assert _close(ta[c], tb[c]), c


def test_zero_noise_matches_oracle_and_reconstructs_exactly():
    _ref, plan = _plans([4, 3, 2])
    margs = _margs(plan, 40)
    eng = plan.engine(secure=True, device="cpu")
    em = eng.measure(margs, torch.Generator().manual_seed(0),
                     _noise_override=_ZERO)
    dm = measure_discrete(plan, margs, random.Random(0),
                          _noise_override=_ZERO)
    for c in plan.cliques:
        assert _close(em[c].omega, dm[c].omega), c
    tables = eng.reconstruct(em)
    for c in plan.workload.cliques:
        assert np.allclose(tables[c], margs[c], atol=1e-4), c


def test_parameters_match_oracle_and_seed_determinism():
    _ref, plan = _plans([4, 3, 2])
    margs = _margs(plan, 30)
    eng = plan.engine(secure=True, device="cpu")
    m1 = eng.measure(margs, torch.Generator().manual_seed(11))
    m2 = eng.measure(margs, torch.Generator().manual_seed(11))
    m3 = eng.measure(margs, torch.Generator().manual_seed(12))
    dm = measure_discrete(plan, margs, random.Random(0))
    for c in plan.cliques:
        assert m1[c].sigma_bar == dm[c].sigma_bar
        assert m1[c].gamma2 == dm[c].gamma2
        assert m1[c].omega.shape == dm[c].omega.shape
    assert all(np.array_equal(m1[c].omega, m2[c].omega) for c in plan.cliques)
    assert any(not np.array_equal(m1[c].omega, m3[c].omega)
               for c in plan.cliques)
    # numpy and random.Random sources work too, deterministically
    n1 = eng.measure(margs, np.random.default_rng(4))
    n2 = eng.measure(margs, np.random.default_rng(4))
    assert all(np.array_equal(n1[c].omega, n2[c].omega) for c in plan.cliques)
    r1 = eng.measure(margs, random.Random(4))
    assert set(r1) == set(plan.cliques)


def test_as_np_rng_is_deterministic_and_typed():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = as_np_rng(g1).integers(0, 1 << 40, 8)
    b = as_np_rng(g2).integers(0, 1 << 40, 8)
    assert np.array_equal(a, b)
    assert not np.array_equal(as_np_rng(g1).integers(0, 1 << 40, 8), a)
    rng = np.random.default_rng(0)
    assert as_np_rng(rng) is rng
    with pytest.raises(TypeError):
        as_np_rng(7)


def test_no_per_clique_kron_matvec_np_on_hot_path(monkeypatch):
    import repro_torch.core.kron as kron
    import repro_torch.core.discrete as disc
    src = (Path(__file__).resolve().parents[1]
           / "src/repro_torch/engine/discrete_engine.py")
    assert "kron_matvec_np(" not in src.read_text()
    _ref, plan = _plans([4, 3, 2])
    margs = _margs(plan, 30)
    eng = plan.engine(secure=True, device="cpu")

    def _boom(*a, **k):
        raise AssertionError("kron_matvec_np called on the secure hot path")
    monkeypatch.setattr(kron, "kron_matvec_np", _boom)
    monkeypatch.setattr(disc, "kron_matvec_np", _boom)
    tables, meas = eng.release(margs, torch.Generator().manual_seed(0))
    assert len(meas) == len(plan.cliques)
    assert set(tables) == set(plan.workload.cliques)


def test_big_gamma2_and_sliver_complete():
    """γ² at 10^40 scale (object lanes) and beyond float64 range (σ̄² ~
    1e304): measurement completes finite; the latter takes the float64 Y†
    host fallback."""
    for sig2, host_y in ((1e34, 0), (1e304, 1)):
        plan, margs = _single([10, 10, 10], 50, seed=0)
        plan.sigma[plan.table.index[(0, 1, 2)]] = sig2
        _sb, gamma2, _n = clique_gamma2(plan, (0, 1, 2))
        assert gamma2 >= 10 ** 40
        eng = plan.engine(secure=True, device="cpu")
        meas = eng.measure(margs, torch.Generator().manual_seed(0))
        assert all(np.all(np.isfinite(m.omega)) for m in meas.values())
        assert eng.stats.host_y_groups == host_y


def test_exact_tier_stays_exact_with_zero_noise():
    plan, margs = _single([10, 10, 10], 10 ** 6)
    eng = plan.engine(secure=True, device="cpu")
    em = eng.measure(margs, torch.Generator().manual_seed(0),
                     _noise_override=_ZERO)
    assert eng.stats.exact_h_groups > 0
    dm = measure_discrete(plan, margs, random.Random(0),
                          _noise_override=_ZERO)
    for c in plan.cliques:
        assert _close(em[c].omega, dm[c].omega), c


def test_kernel_and_plain_chain_paths_agree():
    _ref, plan = _plans([4, 3, 2])
    margs = _margs(plan, 30)
    a = DiscreteEngine(plan, use_kernel=False, device="cpu").measure(
        margs, torch.Generator().manual_seed(5))
    reset_chain_stats()
    b = DiscreteEngine(plan, device="cpu").measure(
        margs, torch.Generator().manual_seed(5))
    assert chain_stats()["fused_chains"] > 0        # through the kernel wrapper
    assert chain_stats()["fused_launches"] == 0     # CPU: the plain version
    for c in plan.cliques:
        assert _close(a[c].omega, b[c].omega), c


def test_measure_chains_stay_float32_when_bf16_is_offered(monkeypatch,
                                                          tmp_path):
    monkeypatch.setenv("REPRO_KERNEL_COMPUTE_DTYPES", "bfloat16")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    from repro_torch.kernels.autotune import reset_registry
    reset_registry()
    try:
        _ref, plan = _plans([9, 7, 5], k=3)
        eng = DiscreteEngine(plan, device="cpu")
        rows = eng.chain_plans()
        assert all(r["compute_dtype"] == "float32" for r in rows
                   if r["role"] == "measure")
        margs = _margs(plan, 3)
        em = eng.measure(margs, torch.Generator().manual_seed(0),
                         _noise_override=_ZERO)
        dm = measure_discrete(plan, margs, random.Random(0),
                              _noise_override=_ZERO)
        for c in plan.cliques:
            assert _close(em[c].omega, dm[c].omega), c
    finally:
        reset_registry()


def test_plus_plan_rejects_secure():
    from repro_torch.core.plus import PlusSchema, select_plus
    dom = Domain.create([8, 5], kinds=["numeric", "categorical"])
    wk = all_kway(dom, 2, include_lower=True)
    schema = PlusSchema.create(dom, ["range", "identity"], device="cpu")
    plan = select_plus(wk, schema, pcost_budget=1.0, device="cpu")
    with pytest.raises(ValueError):
        plan.engine(secure=True)
    with pytest.raises(ValueError):
        DiscreteEngine(plan, device="cpu")


def test_accounting_matches_jax():
    ref, plan = _plans([4, 3, 2])
    eng = DiscreteEngine(plan, device="cpu")
    theirs = JDiscreteEngine(ref, use_kernel=False, precompile=False)
    assert eng.pcost() == theirs.pcost() == discrete_pcost_of_plan(plan)
    assert eng.rho() == theirs.rho()
