"""The port's kron kernels (their plain versions on the CPU) vs the JAX package.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_fused_kernels.py does.  Inputs come from numpy with a seed; the
tolerance is rel 2e-5 of max|reference|, the bound test_fused_kernels uses,
for float32 sums taken in another order.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.kron import kron_matvec as jax_kron_matvec
from repro.core.kron import kron_matvec_batched as jax_kron_matvec_batched
from repro.core.kron import kron_matvec_np
from repro.core.residual import sub_matrix
from repro.kernels.kron_matvec._layout import normalize_factor as jax_normalize
from repro.kernels.kron_matvec.fused import fused_chain_matvec as jax_fused
from repro.kernels.kron_matvec.ops import kron_matvec_kernel as jax_kron_kernel
from repro.kernels.kron_matvec.ops import \
    residual_measure_kernel as jax_residual_measure

from repro_torch.core.kron import kron_matvec, kron_matvec_batched
from repro_torch.kernels.kron_matvec import (apply_epilogue, chain_stats,
                                             fused_chain_matvec,
                                             kron_axis_matvec,
                                             kron_matvec_kernel, plan_chain,
                                             reset_chain_stats,
                                             residual_measure_kernel,
                                             residual_measure_ref)
from repro_torch.kernels.kron_matvec._layout import normalize_factor

REL = 2e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.abs(want).max(), 1e-6)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("dims,batch", [
    ([2], 1), ([3], 5), ([2, 3], 4), ([5, 7, 3], 2), ([17, 6], 9),
    ([9, 2, 4], 1), ([10, 10, 10], 3), ([13], 130),
])
def test_fused_chain_matches_jax(dims, batch, rng):
    facs = [sub_matrix(n) for n in dims]
    x = rng.standard_normal((batch, math.prod(dims))).astype(np.float32)
    want = np.asarray(jax_fused(facs, x, dims, interpret=True))
    reset_chain_stats()
    got = fused_chain_matvec(facs, _t(x), dims)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got, want) < REL
    st = chain_stats()
    assert st["fused_chains"] == 1 and st["fallback_chains"] == 0
    assert st["fused_launches"] == 0      # CPU tensors: plain version, no launch


def test_fused_chain_mixed_factor_kinds_match_jax(rng):
    """None (identity), 'ones' (marginalize) and rectangular factors."""
    dims = [4, 5, 3]
    facs = [None, "ones", rng.standard_normal((7, 3))]
    x = rng.standard_normal((6, 60)).astype(np.float32)
    want = np.asarray(jax_fused(facs, x, dims, interpret=True))
    got = fused_chain_matvec(facs, _t(x), dims)
    assert tuple(got.shape) == want.shape == (6, 4 * 1 * 7)
    assert _rel(got, want) < REL


def test_fused_chain_flat_input_and_identity_chain(rng):
    dims = [3, 4]
    facs = [sub_matrix(3), np.eye(4)]
    x = rng.standard_normal(12).astype(np.float32)
    got = fused_chain_matvec(facs, _t(x), dims)
    want = np.asarray(jax_fused(facs, x, dims, interpret=True))
    assert got.dim() == 1 and _rel(got, want) < REL
    ident = fused_chain_matvec([None, np.eye(4)], _t(x), dims)
    assert torch.equal(ident, _t(x))


@pytest.mark.parametrize("L,n,R,m", [(1, 2, 1, 1), (3, 7, 5, 6), (4, 10, 1, 9),
                                     (2, 13, 37, 13)])
def test_kron_axis_matvec_matches_jax(L, n, R, m, rng):
    s = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal((L, n, R)).astype(np.float32)
    want = np.asarray(jax_kron_kernel([None, s, None], x.reshape(-1),
                                      (L, n, R), interpret=True))
    got = kron_axis_matvec(_t(s), _t(x))
    assert tuple(got.shape) == (L, m, R)
    assert _rel(got.reshape(-1), want) < REL


@pytest.mark.parametrize("dims", [[2], [4, 7], [5, 3, 2]])
def test_per_axis_drivers_match_jax(dims, rng):
    facs = [sub_matrix(n) for n in dims]
    m = math.prod(dims)
    v = rng.standard_normal(m).astype(np.float32)
    z = rng.standard_normal(m).astype(np.float32)
    got = kron_matvec_kernel(facs, _t(v), dims)
    want = np.asarray(jax_kron_kernel(facs, v, dims, interpret=True))
    assert _rel(got, want) < REL
    got = residual_measure_kernel(facs, _t(v), _t(z), 0.7, dims)
    want = np.asarray(jax_residual_measure(facs, v, z, 0.7, dims,
                                           interpret=True))
    assert _rel(got, want) < REL
    assert _rel(residual_measure_ref(facs, _t(v), _t(z), 0.7, dims), want) < REL


def test_plan_chain_routes_by_shared_memory():
    small = plan_chain([sub_matrix(10)] * 3, [10, 10, 10], batch=323_400)
    assert small.fused_ok and small.n_in == 1000 and small.n_out == 729
    assert small.buf == 1000 and small.smem_bytes <= 232448
    big = plan_chain([sub_matrix(100)] * 3, [100, 100, 100], batch=2)
    assert not big.fused_ok                     # 4 MB a row: per-axis kernel
    ident = plan_chain([None, sub_matrix(4)], [6, 4], batch=1)
    assert ident.fshapes == (None, (3, 4)) and ident.out_dims == (6, 3)


def test_per_axis_route_gives_the_same_numbers(rng):
    """fused_ok=False (a tiny budget) runs the per-axis path: on the CPU the
    two plain versions agree bit for bit, and both match JAX's fallback."""
    dims = [8, 9]
    facs = [sub_matrix(n) for n in dims]
    x = rng.standard_normal((4, 72)).astype(np.float32)
    reset_chain_stats()
    fused = fused_chain_matvec(facs, _t(x), dims)
    per_axis = fused_chain_matvec(facs, _t(x), dims, smem_budget=16)
    st = chain_stats()
    assert st["fused_chains"] == 1 and st["fallback_chains"] == 1
    assert torch.equal(fused, per_axis)
    want = np.asarray(jax_fused(facs, x, dims, interpret=True, vmem_budget=16))
    assert _rel(per_axis, want) < REL


def test_wide_chain_takes_the_per_axis_path(rng):
    dims = [40, 40, 40]                         # 256 KB a row
    facs = [sub_matrix(n) for n in dims]
    x = rng.standard_normal((1, 64000)).astype(np.float32)
    reset_chain_stats()
    got = fused_chain_matvec(facs, _t(x), dims)
    assert chain_stats()["fallback_chains"] == 1
    want = kron_matvec_np(facs, x[0], dims)
    assert _rel(got[0], want) < REL


def test_unported_options_raise():
    """Every option of the reference is ported now: narrow compute dtypes
    (tests/test_torch_autotune.py) and the 'cumsum' epilogue (below); only
    an operand type the reference does not have, an unknown op or a wrong
    length raises."""
    x = torch.ones((1, 3))
    with pytest.raises(ValueError, match="compute dtype"):
        fused_chain_matvec([sub_matrix(3)], x, [3], compute_dtype="int8")
    assert fused_chain_matvec([sub_matrix(3)], x, [3],
                              compute_dtype="bfloat16").dtype == torch.float32
    with pytest.raises(ValueError):
        fused_chain_matvec([sub_matrix(3)], x, [3], epilogue=["cummax"])
    with pytest.raises(ValueError):
        fused_chain_matvec([sub_matrix(3)], x, [3], epilogue=["cumsum", None])
    got = fused_chain_matvec([sub_matrix(3)], x, [3], epilogue=["cumsum"])
    assert torch.equal(got, torch.cumsum(fused_chain_matvec([sub_matrix(3)],
                                                            x, [3]), 1))
    with pytest.raises(ValueError):
        fused_chain_matvec([sub_matrix(3)], torch.ones((1, 6)), [3, 2, 1])
    with pytest.raises(TypeError):
        kron_axis_matvec(torch.ones((2, 3), dtype=torch.float64),
                         torch.ones((1, 3, 1), dtype=torch.float64))


@pytest.mark.parametrize("f,n", [(None, 3), ("ones", 4), (np.eye(5), 5),
                                 (np.arange(6.0).reshape(2, 3), 3)])
def test_normalize_factor_means_the_same(f, n):
    mine, ref = normalize_factor(f, n), jax_normalize(f, n)
    assert (mine is None) == (ref is None)
    if ref is not None:
        assert np.array_equal(mine, ref)


def test_torch_kron_matvec_matches_jax(rng):
    dims = [3, 4, 5]
    facs = [sub_matrix(3), "ones", rng.standard_normal((2, 5))]
    x = rng.standard_normal(60).astype(np.float32)
    want = np.asarray(jax_kron_matvec(facs, jnp.asarray(x), dims))
    assert _rel(kron_matvec(facs, _t(x), dims), want) < REL
    xb = rng.standard_normal((7, 60)).astype(np.float32)
    want = np.asarray(jax_kron_matvec_batched(facs, jnp.asarray(xb), dims))
    got = kron_matvec_batched(facs, _t(xb), dims)
    assert tuple(got.shape) == want.shape and _rel(got, want) < REL


# (factors, dims, batch, epilogue, smem_budget): a fused-size chain, a chain
# that takes the per-axis fallback (budget 16 bytes, as JAX's vmem_budget=16),
# an epilogue on an identity-factor axis, and an all-identity chain.
EPILOGUE_CASES = [
    ("fused", [(5, 4), (4, 4), (6, 3)], [4, 4, 3], 7, ["cumsum"] * 3, None),
    ("fused-mixed", [None, (6, 5)], [3, 5], 9, ["cumsum", None], None),
    ("fallback", [(5, 4), None, (3, 3)], [4, 3, 3], 5,
     [None, "cumsum", "cumsum"], 16),
    ("no-live-factor", [None, None], [4, 6], 3, [None, "cumsum"], None),
]


@pytest.mark.parametrize("name,shapes,dims,batch,epi,budget", EPILOGUE_CASES,
                         ids=[c[0] for c in EPILOGUE_CASES])
def test_fused_chain_epilogue_matches_jax(name, shapes, dims, batch, epi,
                                          budget, rng):
    facs = [None if sh is None else rng.standard_normal(sh) for sh in shapes]
    x = rng.standard_normal((batch, math.prod(dims))).astype(np.float32)
    want = np.asarray(jax_fused(facs, x, dims, interpret=True, epilogue=epi,
                                vmem_budget=budget))
    reset_chain_stats()
    got = fused_chain_matvec(facs, _t(x), dims, epilogue=epi,
                             smem_budget=budget)
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) < REL
    st = chain_stats()
    assert st["epilogue_axes"] == sum(op is not None for op in epi)
    assert st["fallback_chains"] == (name == "fallback")
    assert st["fused_launches"] == st["epilogue_launches"] == 0   # CPU


def test_apply_epilogue_is_cumsum_on_marked_axes(rng):
    y = rng.standard_normal((2, 3, 4, 5))
    got = apply_epilogue(torch.as_tensor(y).reshape(2, -1), (3, 4, 5),
                         ("cumsum", None, "cumsum"))
    want = np.cumsum(np.cumsum(y, axis=1), axis=3).reshape(2, -1)
    assert np.allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    same = torch.ones((2, 6))
    assert apply_epilogue(same, (2, 3), (None, None)) is same


def test_plan_chain_carries_the_epilogue():
    facs = [sub_matrix(10)] * 3
    plain = plan_chain(facs, [10, 10, 10], batch=1140)
    epi = plan_chain(facs, [10, 10, 10], batch=1140,
                     epilogue=("cumsum",) * 3)
    assert plain.epilogue == (None,) * 3 and epi.epilogue == ("cumsum",) * 3
    assert (epi.rows, epi.smem_bytes, epi.fused_ok) == \
        (plain.rows, plain.smem_bytes, plain.fused_ok)   # scan in place
    assert epi.signature != plain.signature


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_factor_copies_each_content_once(dtype, rng):
    from repro_torch.kernels.kron_matvec import _layout
    _layout.clear_device_factors()
    a = rng.standard_normal((5, 7)).astype(np.float32)
    t = _layout.device_factor(a, dtype, torch.device("cpu"))
    assert t.dtype == dtype and torch.equal(t, torch.as_tensor(a).to(dtype))
    assert _layout.device_factor(a.copy(), dtype, torch.device("cpu")) is t
    a[0, 0] += 1.0   # the kept tensor is a copy, and new content is new
    u = _layout.device_factor(a, dtype, torch.device("cpu"))
    assert u is not t and torch.equal(u, torch.as_tensor(a).to(dtype))
    assert not torch.equal(u, t)
    _layout.clear_device_factors()


def test_device_factor_drops_the_oldest_past_its_byte_cap(rng, monkeypatch):
    from repro_torch.kernels.kron_matvec import _layout
    _layout.clear_device_factors()
    monkeypatch.setattr(_layout, "_DEVICE_FACTORS_MAX_BYTES", 3 * 4 * 16)
    arrs = [rng.standard_normal((4, 4)).astype(np.float32) for _ in range(5)]
    kept = [_layout.device_factor(a, torch.float32, torch.device("cpu"))
            for a in arrs]
    assert len(_layout._DEVICE_FACTORS) == 3
    assert _layout._device_factor_bytes == 3 * 4 * 16
    assert _layout.device_factor(arrs[-1], torch.float32,
                                 torch.device("cpu")) is kept[-1]
    assert _layout.device_factor(arrs[0], torch.float32,
                                 torch.device("cpu")) is not kept[0]
    _layout.clear_device_factors()
