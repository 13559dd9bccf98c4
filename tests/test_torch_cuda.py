"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Every test here needs an NVIDIA GPU (Hopper, for the sm_90a build) and skips
without one.  Run on a GPU host with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports only torch, numpy and the port, so it runs where JAX is
not installed.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import (Domain, all_kway, exact_marginals_from_x,
                              measure, select_sum_of_variances)
from repro_torch.core.reconstruct import u_chain_factors
from repro_torch.core.residual import sub_matrix
from repro_torch.engine import MarginalEngine
from repro_torch.kernels.kron_matvec import (chain_stats, fused_chain_matvec,
                                             fused_chain_matvec_plain,
                                             kron_axis_matvec,
                                             kron_axis_matvec_plain,
                                             reset_chain_stats)

pytestmark = pytest.mark.cuda

REL = 2e-5   # of max|plain|: the kernels round each fmaf once, the plain
             # versions round the product and the sum apart


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dims,batch", [
    ([2], 1), ([3], 5), ([2, 3], 4), ([5, 7, 3], 2), ([17, 6], 9),
    ([9, 2, 4], 1), ([10, 10, 10], 3), ([13], 130), ([10, 10, 10], 3001),
])
def test_fused_kernel_matches_plain(cuda, dims, batch):
    rng = np.random.default_rng(0)
    facs = [sub_matrix(n).astype(np.float32) for n in dims]
    x = torch.as_tensor(rng.standard_normal((batch, math.prod(dims))),
                        dtype=torch.float32, device=cuda)
    reset_chain_stats()
    got = fused_chain_matvec(facs, x, dims)
    assert chain_stats()["fused_launches"] == 1
    want = fused_chain_matvec_plain(facs, x, dims)
    assert got.shape == want.shape
    assert _rel(got, want) < REL


def test_fused_kernel_mixed_factor_kinds(cuda):
    rng = np.random.default_rng(1)
    dims = [4, 5, 3]
    facs = [None, "ones", rng.standard_normal((7, 3))]
    x = torch.as_tensor(rng.standard_normal((6, 60)), dtype=torch.float32,
                        device=cuda)
    got = fused_chain_matvec(facs, x, dims)
    want = fused_chain_matvec(facs, x.cpu(), dims)
    assert got.shape == (6, 28)
    assert _rel(got.cpu(), want) < REL


@pytest.mark.parametrize("L,n,R,m", [
    (1, 2, 1, 1), (3, 7, 5, 6), (2, 100, 10000, 99), (198, 100, 100, 99),
    (19602, 100, 1, 99), (5, 101, 3, 101), (1000, 10, 1, 9), (1, 13, 517, 13),
])
def test_axis_kernel_matches_plain(cuda, L, n, R, m):
    gen = torch.Generator(device=cuda).manual_seed(0)
    s = torch.randn((m, n), generator=gen, device=cuda)
    x = torch.randn((L, n, R), generator=gen, device=cuda)
    reset_chain_stats()
    got = kron_axis_matvec(s, x)
    assert chain_stats()["axis_launches"] == 1
    assert _rel(got, kron_axis_matvec_plain(s, x)) < REL


def test_fused_and_per_axis_kernels_agree_bit_for_bit(cuda):
    """Both kernels sum k = 0..n-1 with one fmaf per term."""
    rng = np.random.default_rng(2)
    dims = (10, 7, 12)
    dom = Domain.create(list(dims))
    facs = [f.astype(np.float32) for f in u_chain_factors(dom, (0, 1, 2))]
    x = torch.as_tensor(rng.standard_normal((37, math.prod(dims))),
                        dtype=torch.float32, device=cuda)
    reset_chain_stats()
    fused = fused_chain_matvec(facs, x, dims)
    per_axis = fused_chain_matvec(facs, x, dims, smem_budget=16)
    st = chain_stats()
    assert st["fused_launches"] == 1 and st["axis_launches"] == 3
    assert st["fused_chains"] == 1 and st["fallback_chains"] == 1
    assert torch.equal(fused, per_axis)


def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    s = torch.ones((2, 3), device=cuda)
    with pytest.raises(TypeError):
        kron_axis_matvec(s.double(), torch.ones((1, 3, 1), device=cuda).double())
    with pytest.raises(ValueError):
        kron_axis_matvec(s, torch.ones((1, 3, 1)))
    with pytest.raises(NotImplementedError):
        fused_chain_matvec([sub_matrix(3)], torch.ones((1, 3), device=cuda),
                           [3], epilogue=["cumsum"])


def test_batched_and_loop_measure_bit_identical_on_card(cuda):
    dom = Domain.create([3, 5, 2, 7])
    plan = select_sum_of_variances(all_kway(dom, 3, include_lower=True), 1.0)
    x = np.random.default_rng(3).integers(0, 9, dom.universe_size())
    margs = exact_marginals_from_x(dom, plan.cliques, x)
    bat = measure(plan, margs, torch.Generator(cuda).manual_seed(4), device=cuda)
    loop = measure(plan, margs, torch.Generator(cuda).manual_seed(4),
                   batched=False, device=cuda)
    for c in plan.cliques:
        assert np.array_equal(bat[c].omega, loop[c].omega), c


def test_engine_release_on_card_within_six_sigma(cuda):
    dom = Domain.create([40, 40, 40, 5, 3])   # (40,40,40) overflows a block
    plan = select_sum_of_variances(all_kway(dom, 3, include_lower=True), 1.0)
    x = np.random.default_rng(5).integers(0, 3, dom.universe_size())
    margs = exact_marginals_from_x(dom, plan.cliques, x)
    reset_chain_stats()
    eng = MarginalEngine(plan, device=cuda)
    tables, _ = eng.release(margs, torch.Generator(cuda).manual_seed(6))
    st = chain_stats()
    assert st["fused_launches"] > 0 and st["axis_launches"] > 0
    assert eng.stats.fallback_chains > 0
    for c, var in zip(plan.workload.cliques, plan.variances_array()):
        assert np.abs(tables[c] - margs[c]).max() <= 6 * math.sqrt(var), c
