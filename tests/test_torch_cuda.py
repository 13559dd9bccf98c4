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
from repro_torch.core.plus import (PlusSchema, measure_plus_np,
                                   reconstruct_plus, select_plus)
from repro_torch.core.reconstruct import u_chain_factors
from repro_torch.core.residual import sub_matrix
from repro_torch.core.domain import MarginalWorkload
from repro_torch.engine import MarginalEngine
from repro_torch.engine.plus_engine import PlusEngine
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
    with pytest.raises(ValueError, match="compute dtype"):
        fused_chain_matvec([sub_matrix(3)], torch.ones((1, 3), device=cuda),
                           [3], compute_dtype="int8")
    with pytest.raises(ValueError):
        fused_chain_matvec([sub_matrix(3)], torch.ones((1, 3), device=cuda),
                           [3], epilogue=["cummax"])


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


# (dims, factor shapes (None: identity), batch, epilogue, smem_budget, launches):
# fused chains with the scan in the kernel, one on an identity-factor axis,
# and a chain sent to the per-axis route (budget 16 bytes) whose epilogue
# is torch.cumsum after the per-axis kernel.
EPILOGUE_CASES = [
    ([10, 10, 10], [(10, 10)] * 3, 1140, ["cumsum"] * 3, None, (1, 0)),
    ([7, 5], [None, (6, 5)], 33, ["cumsum", None], None, (1, 0)),
    ([4, 100, 3], [(4, 4), None, (2, 3)], 9, [None, "cumsum", "cumsum"], None,
     (1, 0)),
    ([9, 8, 7], [(9, 9), (8, 8), None], 5, ["cumsum", None, "cumsum"], 16,
     (0, 2)),
]


@pytest.mark.parametrize("dims,shapes,batch,epi,budget,launches",
                         EPILOGUE_CASES)
def test_fused_kernel_epilogue_matches_plain(cuda, dims, shapes, batch, epi,
                                             budget, launches):
    """The scan adds from index 0 in float32; torch.cumsum sums in another
    order on the card: rel 2e-5 of max|plain|, not bit for bit."""
    rng = np.random.default_rng(7)
    facs = [None if sh is None else rng.standard_normal(sh).astype(np.float32)
            for sh in shapes]
    x = torch.as_tensor(rng.standard_normal((batch, math.prod(dims))),
                        dtype=torch.float32, device=cuda)
    reset_chain_stats()
    got = fused_chain_matvec(facs, x, dims, epilogue=epi, smem_budget=budget)
    st = chain_stats()
    assert (st["fused_launches"], st["axis_launches"]) == launches
    assert st["epilogue_launches"] == launches[0]
    assert st["epilogue_axes"] == sum(op is not None for op in epi)
    want = fused_chain_matvec_plain(facs, x, dims, epi)
    assert got.shape == want.shape
    assert _rel(got, want) < REL


def test_epilogue_without_a_live_factor_launches_nothing(cuda):
    x = torch.randn((4, 30), device=cuda)
    reset_chain_stats()
    got = fused_chain_matvec([None, None], x, [5, 6], epilogue=[None, "cumsum"])
    assert chain_stats()["fused_launches"] == 0
    assert torch.equal(got, torch.cumsum(x.view(4, 5, 6), 2).view(4, 30))


def test_no_epilogue_stays_bit_identical(cuda):
    """An all-None epilogue is the plain chain: fused == per-axis bit for bit,
    and no launch counts as an epilogue launch."""
    rng = np.random.default_rng(8)
    dims = (10, 7, 12)
    facs = [rng.standard_normal((n, n)).astype(np.float32) for n in dims]
    x = torch.as_tensor(rng.standard_normal((41, math.prod(dims))),
                        dtype=torch.float32, device=cuda)
    reset_chain_stats()
    a = fused_chain_matvec(facs, x, dims, epilogue=(None,) * 3)
    b = fused_chain_matvec(facs, x, dims)
    c = fused_chain_matvec(facs, x, dims, smem_budget=16)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert chain_stats()["epilogue_launches"] == 0


class _Replay:
    def __init__(self, draws, order):
        self._queue = [draws[c] for c in order]

    def standard_normal(self, n):
        z = self._queue.pop(0)
        assert z.shape == (n,)
        return z


def test_plus_engine_on_card_matches_oracles(cuda):
    """A mixed range/identity/prefix schema with a p-Identity strategy and a
    (40, 40, 40) chain that takes the per-axis route: measure and
    reconstruct on the card against the float64 oracles, fed the card's
    noise; both kernels and the in-kernel epilogue launched."""
    dom = Domain.create([40, 40, 40, 5, 6])
    kinds = ["prefix", "prefix", "identity", "range", "identity"]
    schema = PlusSchema.create(dom, kinds, strategy_mode="auto", device=cuda)
    wk = MarginalWorkload(dom, ((0, 1, 2), (3, 4), (1, 3), (0, 3, 4), (2,)))
    plan = select_plus(wk, schema, 1.0, "sov", device=cuda)
    rng = np.random.default_rng(9)
    margs = {c: rng.integers(0, 50, dom.n_cells(c)).astype(float)
             for c in plan.cliques}
    reset_chain_stats()
    eng = PlusEngine(plan, device=cuda)
    meas = eng.measure(margs, torch.Generator(cuda).manual_seed(3))
    tables = eng.reconstruct(meas)
    torch.cuda.synchronize()
    st = chain_stats()
    assert st["fused_launches"] > 0 and st["axis_launches"] > 0
    assert st["epilogue_launches"] > 0
    oracle = measure_plus_np(plan, margs, _Replay(
        eng.noise_draws(torch.Generator(cuda).manual_seed(3)), plan.cliques))
    for c in plan.cliques:
        scale = max(np.abs(oracle[c].omega).max(), 1.0)
        assert np.abs(meas[c].omega - oracle[c].omega).max() / scale < 1e-4, c
    for c in wk.cliques:
        want = reconstruct_plus(plan, oracle, c)
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(tables[c] - want).max() / scale < 1e-4, c


# ------------------------------------------------------------ narrow operands
NARROW_TOL = {"bfloat16": 1e-2, "float16": 2e-3}   # of max|plain|


@pytest.mark.parametrize("cd", ["bfloat16", "float16"])
@pytest.mark.parametrize("epi", [None, ("cumsum",) * 3])
@pytest.mark.parametrize("rows", [None, 1, 3, 8, 16])
def test_narrow_kernel_matches_narrow_plain(cuda, cd, epi, rows):
    """The templated kernel at bf16/fp16 against the narrow plain version on
    the card, across a rows lattice.  Operand products are exact in float32,
    so without an epilogue the two round at the same points."""
    dom = Domain.create([10, 10, 10])
    facs = [f.astype(np.float32) for f in u_chain_factors(dom, (0, 1, 2))]
    x = torch.as_tensor(np.random.default_rng(10).standard_normal((1001, 1000)),
                        dtype=torch.float32, device=cuda)
    reset_chain_stats()
    got = fused_chain_matvec(facs, x, (10, 10, 10), epilogue=epi, rows=rows,
                             compute_dtype=cd)
    st = chain_stats()
    assert st["fused_launches"] == st["narrow_launches"] == 1
    assert st["bf16_launches" if cd == "bfloat16" else "fp16_launches"] == 1
    want = fused_chain_matvec_plain(facs, x, (10, 10, 10), epi, cd)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) < NARROW_TOL[cd]
    assert _rel(got, fused_chain_matvec_plain(facs, x, (10, 10, 10), epi)) \
        < 3 * NARROW_TOL[cd]


def test_narrow_kernel_fits_chains_fp32_cannot(cuda):
    rng = np.random.default_rng(11)
    dims = (32, 32, 32)
    facs = [rng.standard_normal((32, 32)).astype(np.float32) for _ in dims]
    x = torch.as_tensor(rng.standard_normal((5, 32768)), dtype=torch.float32,
                        device=cuda)
    reset_chain_stats()
    got = fused_chain_matvec(facs, x, dims, compute_dtype="bfloat16")
    wide = fused_chain_matvec(facs, x, dims, compute_dtype="float32")
    st = chain_stats()
    assert st["narrow_launches"] == 1 and st["axis_launches"] == 3
    assert _rel(got, fused_chain_matvec_plain(facs, x, dims, None,
                                              "bfloat16")) < 1e-2
    assert _rel(got, wide) < 3e-2


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 7, 8, 16])
def test_tuned_rows_bit_identical_to_untuned_on_card(cuda, rows):
    rng = np.random.default_rng(12)
    dims = (10, 7, 12)
    facs = [rng.standard_normal((n, n)).astype(np.float32) for n in dims]
    x = torch.as_tensor(rng.standard_normal((53, math.prod(dims))),
                        dtype=torch.float32, device=cuda)
    untuned = fused_chain_matvec(facs, x, dims, smem_budget=232448)
    assert torch.equal(untuned, fused_chain_matvec(facs, x, dims, rows=rows))


def test_model_and_measure_modes_on_card(cuda, tmp_path, monkeypatch):
    """model mode serves the untuned bits; measure mode times kernels on the
    card, tags its pick and writes the cache."""
    from repro_torch.kernels.autotune import (TuningCache, reset_registry,
                                              tune_chain)
    from repro_torch.roofline import detect_device
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    reset_registry()
    rng = np.random.default_rng(13)
    dims = (10, 10, 10)
    facs = [sub_matrix(10).astype(np.float32)] * 3
    x = torch.as_tensor(rng.standard_normal((4000, 1000)), dtype=torch.float32,
                        device=cuda)
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "off")
    off = fused_chain_matvec(facs, x, dims)
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "model")
    assert torch.equal(off, fused_chain_matvec(facs, x, dims))
    cfg = tune_chain(facs, dims, batch=4000, device=cuda, mode="measure",
                     dtypes=("float32", "bfloat16"))
    assert cfg.source == "measure" and cfg.predicted_s > 0
    assert len(TuningCache(detect_device(cuda).kind).load()) == 1
    reset_registry()


def test_narrow_clamp_on_card(cuda, tmp_path, monkeypatch):
    """A cached bf16 config whose rows overflow a block at float32 reaches a
    call without allow_narrow: re-planned at float32, no launch failure,
    float32 bits."""
    from repro_torch.kernels.autotune import (TunedConfig, TuningCache,
                                              chain_key, reset_registry)
    from repro_torch.kernels.kron_matvec.fused import factor_shapes, plan_chain
    from repro_torch.roofline import detect_device
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "model")
    monkeypatch.setenv("REPRO_KERNEL_COMPUTE_DTYPES", "bfloat16")
    reset_registry()
    rng = np.random.default_rng(14)
    dims = (30, 30, 30)
    facs = [rng.standard_normal((30, 30)).astype(np.float32) for _ in dims]
    x = torch.as_tensor(rng.standard_normal((9, 27000)), dtype=torch.float32,
                        device=cuda)
    narrow = plan_chain(facs, dims, batch=9, rows=2, compute_dtype="bfloat16")
    assert narrow.fused_ok and not plan_chain(facs, dims, rows=2).fused_ok
    kind = detect_device(cuda).kind
    TuningCache(kind).put(
        chain_key(kind, dims, factor_shapes(facs, dims), None, 9,
                  ("bfloat16",)),
        TunedConfig(rows=2, smem_budget=narrow.smem_bytes,
                    compute_dtype="bfloat16").as_dict())
    reset_chain_stats()
    clamped = fused_chain_matvec(facs, x, dims)
    torch.cuda.synchronize()
    assert chain_stats()["narrow_launches"] == 0
    assert torch.equal(clamped, fused_chain_matvec(facs, x, dims,
                                                   compute_dtype="float32"))
    served = fused_chain_matvec(facs, x, dims, allow_narrow=True)
    assert chain_stats()["narrow_launches"] == 1
    assert _rel(served, clamped) < 3e-2
    reset_registry()


# ------------------------------------------------------------ ragged shapes
# Fused chains over both contractions of the kernel: the register path
# (n <= 16) and the streamed one (n = 17, 40, 100, 130, with m = 5, 3, 99,
# 7 leaving a ragged group of 4 outputs), identity axes, row widths that
# leave the staging unaligned (21, 35), and batches that leave the last
# block ragged.  (dims, factor shapes (None:
# identity), batch, epilogue)
RAGGED_FUSED = [
    ((17, 6), [(5, 17), (6, 6)], 9, None),
    ((3, 7), [(2, 3), None], 13, None),
    ((40, 5), [None, (3, 5)], 7, ("cumsum", None)),
    ((2, 100), [(1, 2), (99, 100)], 5, None),
    ((130,), [(7, 130)], 33, None),
    ((5, 7, 9), [(5, 5), None, (4, 9)], 31, ("cumsum", "cumsum", None)),
    ((1, 16, 3), [(2, 1), (16, 16), (1, 3)], 101, (None, "cumsum", None)),
]


def _ragged_fused(case, seed):
    dims, shapes, batch, epi = case
    rng = np.random.default_rng(seed)
    facs = [None if sh is None else rng.standard_normal(sh).astype(np.float32)
            for sh in shapes]
    x = rng.standard_normal((batch, math.prod(dims)))
    return dims, facs, x, epi


@pytest.mark.parametrize("cd", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", RAGGED_FUSED)
def test_fused_kernel_ragged_shapes_match_plain(cuda, case, cd):
    """Both contractions and the staging edges against the plain version at
    each operand type: float32 within REL; narrow bit for bit without an
    epilogue (bf16/fp16 products are exact in float32), within its
    tolerance with one."""
    dims, facs, x, epi = _ragged_fused(case, 15)
    x = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    for rows in (None, 1, 3):
        reset_chain_stats()
        got = fused_chain_matvec(facs, x, dims, epilogue=epi, rows=rows,
                                 compute_dtype=cd)
        assert chain_stats()["fused_launches"] == 1
        want = fused_chain_matvec_plain(facs, x, dims, epi, cd)
        assert got.shape == want.shape
        if cd == "float32":
            assert _rel(got, want) < REL
        elif epi is None:
            assert torch.equal(got, want)
        else:
            assert _rel(got, want) < NARROW_TOL[cd]


@pytest.mark.parametrize("case", [c for c in RAGGED_FUSED if c[3] is None])
def test_fused_and_per_axis_kernels_agree_on_ragged_shapes(cuda, case):
    """The summation contract across both contractions and the per-axis
    kernel's k chunks: fused == per-axis bit for bit, at every rows."""
    dims, facs, x, _ = _ragged_fused(case, 16)
    x = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    per_axis = fused_chain_matvec(facs, x, dims, smem_budget=16)
    for rows in (None, 1, 2, 7):
        reset_chain_stats()
        fused = fused_chain_matvec(facs, x, dims, rows=rows,
                                   smem_budget=232448)
        assert chain_stats()["fused_launches"] == 1
        assert torch.equal(fused, per_axis)


@pytest.mark.parametrize("L,n,R,m", [
    (1, 17, 1, 1), (3, 33, 1, 3), (7, 16, 129, 8), (2, 130, 3, 65),
    (300, 5, 1, 130), (1, 1000, 2, 9), (129, 64, 1, 64), (5, 2, 7001, 2),
    (3, 9, 5, 40), (2, 100, 10000, 99),
])
def test_axis_kernel_ragged_tiles_match_plain(cuda, L, n, R, m):
    """Each tile shape (m <= 32, <= 64, above), m below a lane row's 8 q and
    above one 128-q tile, n across several 8-value chunks, L * R off the
    tile's columns, R == 1 and R > 1."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    s = torch.randn((m, n), generator=gen, device=cuda)
    x = torch.randn((L, n, R), generator=gen, device=cuda)
    reset_chain_stats()
    got = kron_axis_matvec(s, x)
    assert chain_stats()["axis_launches"] == 1
    assert got.shape == (L, m, R)
    assert _rel(got, kron_axis_matvec_plain(s, x)) < REL
    # the per-axis sum order is the fused kernel's where the chain fits
    from repro_torch.kernels.kron_matvec.fused import plan_chain
    facs = [None, s.cpu().numpy(), None]
    if plan_chain(facs, (L, n, R)).fused_ok:
        reset_chain_stats()
        fused = fused_chain_matvec(facs, x.reshape(1, -1), (L, n, R),
                                   smem_budget=232448)
        assert chain_stats()["fused_launches"] == 1
        assert torch.equal(fused.reshape(L, m, R), got)


# ------------------------------------------------ secure release and planner

def _int64_h(vs, dims):
    from repro_torch.core.discrete import h_factors
    from repro_torch.core.kron import kron_matvec_np_batched
    return kron_matvec_np_batched(h_factors(dims, np.int64),
                                  np.rint(vs).astype(np.int64), dims)


@pytest.mark.parametrize("dims,rows,one_cell", [
    ((10, 10), 1, True), ((10, 10), 37, False), ((9, 7, 5), 300, False),
    ((2, 6), 5, False), ((100,), 3, False)])
@pytest.mark.parametrize("route", ["fused", "axis"])
def test_device_h_equals_int64_h_through_both_kernels(cuda, dims, rows,
                                                      one_cell, route):
    """Inputs at the float32 bound (‖v‖₁·Π2n·max n just below 2^24): the
    kernel's float32 H equals the int64 H exactly, before any rint, on the
    fused kernel (the full 227 KB budget, untuned) and on the per-axis
    route (a 16-byte budget forces it)."""
    from repro_torch.core.discrete import h_factors
    n_in = math.prod(dims)
    l1 = (2 ** 24 - 1) // (math.prod(2 * n for n in dims) * max(dims))
    rng = np.random.default_rng(rows)
    if one_cell:
        vs = np.zeros((rows, n_in))
        vs[:, n_in // 3] = l1
    else:
        vs = np.stack([rng.multinomial(l1, np.full(n_in, 1.0 / n_in))
                       for _ in range(rows)]).astype(np.float64)
    x = torch.as_tensor(vs, dtype=torch.float32, device=cuda)
    reset_chain_stats()
    got = fused_chain_matvec(h_factors(dims), x, dims,
                             smem_budget=16 if route == "axis" else 232448)
    st = chain_stats()
    assert (st["fused_launches"], st["axis_launches"] > 0) == \
        ((1, False) if route == "fused" else (0, True))
    assert np.array_equal(got.cpu().numpy().astype(np.float64),
                          _int64_h(vs, dims).astype(np.float64))


def test_secure_release_on_card_device_tier_exact(cuda):
    """DiscreteEngine on the card: every device-tier group's H equals the
    int64 H, both kernels run, and the tables land within 6σ (σ² from the
    plan with each σ²_A replaced by the engine's σ̄²_A)."""
    from repro_torch.engine import DiscreteEngine
    dom = Domain.create([40, 40, 40, 5, 3])
    plan = select_sum_of_variances(all_kway(dom, 3, include_lower=True), 1.0)
    x = np.random.default_rng(5).integers(0, 2, dom.universe_size())
    x[:x.size // 4] = 0
    margs = exact_marginals_from_x(dom, plan.cliques, x)
    eng = DiscreteEngine(plan, device=cuda)
    seen = []
    h = eng._h_transform

    def checked(vs, dims):
        before = eng.stats.device_h_groups
        out = h(vs, dims)
        if eng.stats.device_h_groups > before:
            assert np.array_equal(out, _int64_h(vs, dims)), dims
            seen.append(dims)
        return out
    eng._h_transform = checked
    reset_chain_stats()
    tables, _ = eng.release(margs, torch.Generator(cuda).manual_seed(6))
    st = chain_stats()
    assert st["fused_launches"] > 0 and st["axis_launches"] > 0
    assert seen and eng.stats.exact_h_groups > 0
    bar = plan.sigma.copy()
    for c, sb in eng.sigma_bars.items():
        bar[plan.table.index[c]] = float(sb) ** 2
    for c, var in zip(plan.workload.cliques, plan.table.variances(bar)):
        assert np.abs(tables[c] - margs[c]).max() <= 6 * math.sqrt(var), c


def test_secure_measure_chains_stay_float32_when_bf16_is_offered(
        cuda, tmp_path, monkeypatch):
    from repro_torch.engine import DiscreteEngine
    from repro_torch.kernels.autotune import reset_registry
    monkeypatch.setenv("REPRO_KERNEL_COMPUTE_DTYPES", "bfloat16")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    reset_registry()
    dom = Domain.create([10, 10, 10, 10])
    plan = select_sum_of_variances(all_kway(dom, 3, include_lower=True), 1.0)
    x = np.random.default_rng(2).integers(0, 2, dom.universe_size())
    margs = exact_marginals_from_x(dom, plan.cliques, x)
    eng = DiscreteEngine(plan, device=cuda)
    assert all(r["compute_dtype"] == "float32" for r in eng.chain_plans()
               if r["role"] == "measure")
    reset_chain_stats()
    meas = eng.measure(margs, torch.Generator(cuda).manual_seed(1))
    st = chain_stats()
    assert st["fused_launches"] > 0 and st["narrow_launches"] == 0
    eng.reconstruct(meas)
    reset_registry()


def test_device_maxvar_on_card_within_the_gap(cuda):
    from repro_torch.core.select import _maxvar_eval_fp64, select_max_variance
    dom = Domain.create([5, 3, 4, 2, 6])
    wk = all_kway(dom, 3, include_lower=True)
    a = select_max_variance(wk, 1.0, iters=1500, backend="numpy")
    b = select_max_variance(wk, 1.0, iters=1500, backend="device", chunk=250,
                            device=cuda)
    t = b.table
    cw = t.weight_vector(None, default_to_workload=True)
    gaps = []
    for p in (a, b):
        primal, _u, dual = _maxvar_eval_fp64(p.mu, t.p, t.inc_rows,
                                             t.inc_cols, t.inc_vals, cw, 1.0,
                                             t.n, t.m)
        gaps.append(primal - dual)
    assert abs(a.loss_value - b.loss_value) <= sum(gaps) + 1e-12 * a.loss_value
    assert b.pcost == pytest.approx(1.0, rel=1e-9)


def _two_calls_equal(fn):
    a, b = fn(), fn()
    return np.array_equal(a, b)


@pytest.mark.parametrize("sizes", [[5, 3, 4, 2, 6], [10] * 12])
def test_device_maxvar_bit_identical_over_two_calls(cuda, sizes):
    from repro_torch.core.select import select_max_variance
    wk = all_kway(Domain.create(sizes), 3, include_lower=True)
    assert _two_calls_equal(lambda: select_max_variance(
        wk, 1.0, iters=500, backend="device", device=cuda).sigma)


def _l2_of_variances(var):
    return torch.sqrt(torch.sum(var * var))


@pytest.mark.parametrize("loss", ["max_variance", _l2_of_variances])
def test_select_convex_bit_identical_over_two_calls(cuda, loss):
    from repro_torch.core import select_convex
    wk = all_kway(Domain.create([100, 100, 99, 85, 9, 7, 2, 2]), 3,
                  include_lower=True)
    assert _two_calls_equal(lambda: select_convex(
        wk, 1.0, loss=loss, steps=300, device=cuda).sigma)


def _release_case(sizes, k, seed=0):
    """(plan, raw tables) of a small release on the card."""
    plan = select_sum_of_variances(all_kway(Domain.create(sizes), k,
                                            include_lower=True), 1.0)
    x = np.random.default_rng(seed).integers(0, 3, plan.domain.universe_size())
    margs = exact_marginals_from_x(plan.domain, plan.cliques, x)
    eng = MarginalEngine(plan, device="cuda")
    tables, _ = eng.release(margs, torch.Generator("cuda").manual_seed(seed))
    return plan, tables


@pytest.mark.parametrize("sizes,k,route", [
    ([10, 10, 10, 4], 3, "fused_launches"),        # every chain fits a block
    ([40, 40, 40, 3], 3, "axis_launches"),          # (40,40,40) goes per axis
])
def test_consistency_cg_kernel_route_matches_plain_on_card(cuda, sizes, k,
                                                          route):
    """The CG's chains on the kernels against the plain torch chain on the
    card (atol 5e-5 of max|r|), the route's kernel launched, and two solves
    from one set of tables equal bit for bit."""
    from repro_torch.release import solve_consistency
    plan, tables = _release_case(sizes, k)
    reset_chain_stats()
    got = solve_consistency(plan, tables, device=cuda, use_kernel=True)
    st = chain_stats()
    assert st[route] > 0, st
    plain = solve_consistency(plan, tables, device=cuda, use_kernel=False)
    host = solve_consistency(plan, tables, backend="host")
    scale = max(float(np.abs(host.r).max()), 1.0)
    assert float(np.abs(got.r - plain.r).max()) <= 5e-5 * scale
    assert float(np.abs(got.r - host.r).max()) <= 5e-5 * scale
    again = solve_consistency(plan, tables, device=cuda, use_kernel=True)
    assert np.array_equal(got.r, again.r)
    assert got.iterations == again.iterations


def test_engine_postprocess_and_synthesize_on_card(cuda):
    """nonneg on the card: non-negative, exact totals, the same tables on
    two calls; synthesize from a card generator."""
    plan = select_sum_of_variances(all_kway(Domain.create([10, 10, 10, 4]), 2,
                                            include_lower=True), 1.0)
    x = np.random.default_rng(1).integers(0, 3, plan.domain.universe_size())
    margs = exact_marginals_from_x(plan.domain, plan.cliques, x)
    eng = MarginalEngine(plan, device="cuda")
    total = float(x.sum())
    runs = [eng.release(margs, torch.Generator("cuda").manual_seed(3),
                        postprocess="nonneg", total=total)[0]
            for _ in range(2)]
    for c in plan.workload.cliques:
        assert np.array_equal(runs[0][c], runs[1][c])
        assert np.all(runs[0][c] >= 0)
        assert round(float(runs[0][c].sum())) == int(total)
    recs = eng.synthesize(10_000, torch.Generator("cuda").manual_seed(4))
    assert recs.shape == (10_000, 4) and recs.dtype == np.int32
    assert np.array_equal(recs, eng.synthesize(
        10_000, torch.Generator("cuda").manual_seed(4)))


def test_kernels_copy_each_factor_once_and_never_serve_a_stale_one(cuda):
    from repro_torch.kernels.kron_matvec import _layout
    _layout.clear_device_factors()
    rng = np.random.default_rng(5)
    dims = (10, 10, 10)
    facs = [rng.standard_normal((9, 10)).astype(np.float32) for _ in dims]
    x = torch.as_tensor(rng.standard_normal((300, 1000)), dtype=torch.float32,
                        device=cuda)
    for kw in ({}, {"smem_budget": 0}):     # fused, then per-axis
        first = fused_chain_matvec(facs, x, dims, **kw)
        held = len(_layout._DEVICE_FACTORS)
        assert held >= 1
        assert torch.equal(fused_chain_matvec(facs, x, dims, **kw), first)
        assert len(_layout._DEVICE_FACTORS) == held
        moved = [f.copy() for f in facs]
        moved[1][3, 4] += 2.0
        got = fused_chain_matvec(moved, x, dims, **kw)
        assert _rel(got, fused_chain_matvec_plain(moved, x, dims)) < REL
        assert not torch.equal(got, first)
    _layout.clear_device_factors()


def test_rplus_maxvar_bit_identical_over_two_calls(cuda):
    """RP+ max-variance on the card adds in an order the data fix: two calls
    give the same sigma bit for bit.  Its loss is within rel 5e-3 of the CPU
    route's: the last iterate's loss depends on the order of addition by
    about the +-0.2% the reference's own iterates wander (ROADMAP)."""
    sizes, kinds = [4, 4], ["range", "range"]
    wk = all_kway(Domain.create(sizes), 2, include_lower=True)

    def run(dev):
        schema = PlusSchema.create(Domain.create(sizes), kinds,
                                   strategy_mode="hier", device=dev)
        return select_plus(wk, schema, 1.0, "max_variance", steps=3000,
                           lr=0.01, device=dev)

    a, b = run(cuda), run(cuda)
    assert np.array_equal(a.sigma, b.sigma)
    assert a.loss_value == b.loss_value
    cpu = run("cpu")
    assert a.loss_value == pytest.approx(cpu.loss_value, rel=5e-3)


def _composite_case():
    from repro_torch.core import select_dnc
    from repro_torch.data.tabular import synthetic_records
    sizes = [5, 3, 4, 2, 6, 3, 2, 4]
    cl = [()] + [(i,) for i in range(8)] + [
        (0, 1), (1, 2), (0, 2), (0, 1, 2), (3, 4), (4, 5), (3, 5),
        (6, 7), (2, 6), (1, 4)]
    wk = MarginalWorkload(Domain.create(sizes), tuple(cl))
    plan = select_dnc(wk, 2.0, blocks=[[0, 1, 2], [3, 4, 5], [6, 7]])
    recs = synthetic_records(wk.domain, 3000, seed=5)
    return plan, recs


def test_composite_release_on_card_matches_cpu_route(cuda):
    """The card's CompositeEngine measurements, reconstructed on the card
    and by the CPU route: the same tables to float32; two card releases
    from one seed are identical; in-block tables within 6 sigma."""
    from repro_torch.data.tabular import marginals_from_records
    plan, recs = _composite_case()
    assert plan.decomposition.n_straddlers == 2
    margs = marginals_from_records(plan.domain, plan.cliques, recs)
    card, host = plan.engine(device=cuda), plan.engine(device="cpu")
    reset_chain_stats()
    tables, meas = card.release(margs, torch.Generator(cuda).manual_seed(3))
    assert chain_stats()["fused_launches"] > 0
    want = host.reconstruct(meas)
    for c in plan.workload.cliques:
        w = np.asarray(want[c], np.float64)
        assert np.abs(np.asarray(tables[c], np.float64) - w).max() <= \
            1e-5 * max(1.0, np.abs(w).max()), c
    again, _ = card.release(margs, torch.Generator(cuda).manual_seed(3))
    assert all(np.array_equal(again[c], tables[c]) for c in tables)
    exact = marginals_from_records(plan.domain, plan.workload.cliques, recs)
    var = plan.workload_variances()
    row_block = plan.decomposition.row_block
    for r, c in enumerate(plan.workload.cliques):
        if row_block[r] >= 0:
            assert np.abs(tables[c] - exact[c]).max() <= \
                6 * math.sqrt(var[c]), c


def test_sharded_tables_on_card_equal_cpu_tables(cuda):
    from repro_torch.data.tabular import synthetic_records
    from repro_torch.engine import sharded_marginals, sharded_measure
    dom = Domain.create([100, 100, 99, 85, 9, 7, 2, 2])
    cliques = all_kway(dom, 3, include_lower=True).closure()
    recs = synthetic_records(dom, 20000, seed=2)
    got = sharded_marginals(dom, cliques, recs, device=cuda)
    want = sharded_marginals(dom, cliques, recs, device="cpu")
    assert all(np.array_equal(got[c], want[c]) for c in cliques)
    plan = select_sum_of_variances(all_kway(dom, 2, include_lower=True), 1.0)
    eng = plan.engine(device=cuda)
    m1 = sharded_measure(plan, recs, torch.Generator(cuda).manual_seed(1),
                         device=cuda)
    m2 = eng.measure(sharded_marginals(dom, plan.cliques, recs, device=cuda),
                     torch.Generator(cuda).manual_seed(1))
    assert all(np.array_equal(m1[c].omega, m2[c].omega) for c in plan.cliques)


def test_measure_multi_on_card_equals_measure_bit_for_bit(cuda):
    """Three tenants' plans over chains that go to both kernels: one
    measure_multi call returns every item's measure() bits, though its
    stacked batches (and so the tuner's routes and rows) differ."""
    from repro_torch.data.tabular import (marginals_from_records,
                                          synthetic_records)
    from repro_torch.engine.multi import measure_multi
    dom = Domain.create([100, 100, 99, 85, 9, 7, 2, 2])
    wk = all_kway(dom, 3, include_lower=True)
    plans = [select_sum_of_variances(wk, 1.0) for _ in range(3)]
    margs = [marginals_from_records(dom, p.cliques,
                                    synthetic_records(dom, 5000, seed=t))
             for t, p in enumerate(plans)]
    want = [measure(p, m, torch.Generator(cuda).manual_seed(t))
            for t, (p, m) in enumerate(zip(plans, margs))]
    reset_chain_stats()
    got = measure_multi([(p, m, torch.Generator(cuda).manual_seed(t))
                         for t, (p, m) in enumerate(zip(plans, margs))])
    st = chain_stats()
    assert st["fused_launches"] > 0 and st["axis_launches"] > 0
    for w, g in zip(want, got):
        assert all(np.array_equal(w[c].omega, g[c].omega) for c in w)


def test_release_server_on_card(cuda, tmp_path):
    """A paused batch of three tenants on the card: fused, bit-identical to
    the same requests at max_batch=1; the pool keys None, "cuda" and
    "cuda:<current>" as one device."""
    from repro_torch.data.tabular import (marginals_from_records,
                                          synthetic_records)
    from repro_torch.serve import (BudgetLedger, EnginePool, ReleaseRequest,
                                   ReleaseServer)
    dom = Domain.create([5, 5, 5])
    plans = [select_sum_of_variances(all_kway(dom, 2, include_lower=True),
                                     1.0) for _ in range(3)]
    margs = [marginals_from_records(dom, p.cliques,
                                    synthetic_records(dom, 2000, seed=t))
             for t, p in enumerate(plans)]

    def drain(max_batch):
        srv = ReleaseServer(BudgetLedger(str(tmp_path / f"l{max_batch}"),
                                         fsync=False),
                            max_batch=max_batch).start()
        try:
            for t, p in enumerate(plans):
                srv.register_tenant(f"t{t}", p, rho=10.0)
            srv.pause()
            futs = [srv.submit(ReleaseRequest(tenant=f"t{t}",
                                              marginals=margs[t], seed=t))
                    for t in range(3)]
            srv.resume()
            return [f.result(120) for f in futs]
        finally:
            srv.stop()
            srv.ledger.close()

    bat, seq = drain(8), drain(1)
    assert all(r.batched for r in bat) and not any(r.batched for r in seq)
    for a, b in zip(bat, seq):
        assert all(np.array_equal(a.tables[c], b.tables[c]) for c in a.tables)
    pool = EnginePool()
    idx = torch.cuda.current_device()
    e = pool.engine_for("a", plans[0])
    assert pool.engine_for("a", plans[0], device="cuda") is e
    assert pool.engine_for("a", plans[0], device=f"cuda:{idx}") is e
    assert len(pool.cache) == 1 and e.device.type == "cuda"


@pytest.mark.parametrize("sizes,k,kinds,route", [
    ([10, 10], 2, None, "fused"),
    ([6, 5, 4, 3], 2, ["prefix", "identity", "identity", "range"], "fused"),
    ([100, 50, 7, 4, 2], 2, ["prefix", "prefix", "identity", "identity",
                             "identity"], "axis"),
    ([10] * 7, 1, None, "axis"),          # a 10^7-cell universe, one row
])
def test_hdmm_measure_reconstruct_on_card_matches_cpu(cuda, sizes, k, kinds,
                                                      route):
    """HDMM's universe-sized chains on the kernels against the same chains'
    plain versions (device="cpu"), fed the same standard normal vectors:
    the fused kernel while the universe fits a block, the per-axis kernel
    (m = 1 ones rows included) beyond."""
    from repro_torch.baselines import hdmm_generalized, hdmm_marginals
    from repro_torch.baselines.hdmm import _measure_reconstruct
    wk = all_kway(Domain.create(sizes), k, include_lower=True)
    union = hdmm_marginals(wk) if kinds is None else \
        hdmm_generalized(wk, kinds, iters=50, device=cuda)
    x = np.random.default_rng(0).integers(0, 5, wk.domain.universe_size())

    def run(dev):
        rng = np.random.default_rng(1)
        return _measure_reconstruct(
            union, wk.domain, torch.as_tensor(x, device=dev),
            lambda m: torch.as_tensor(rng.standard_normal(m), device=dev),
            0.5, torch.device(dev))

    reset_chain_stats()
    got = run("cuda")
    torch.cuda.synchronize()
    st = chain_stats()
    if route == "fused":
        assert st["fused_launches"] > 0 and st["axis_launches"] == 0
    else:
        assert st["axis_launches"] > 0 and st["fused_launches"] == 0
    want = run("cpu")
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.float32
        assert float((g.cpu() - w).abs().max()) <= REL * scale


# ---------------------------------------------------------------------------
# The LM plane's serving path (repro_torch.models) on the card
# ---------------------------------------------------------------------------

# one reduced architecture per block kind: attn with qk-norm; rglru and
# attn_local; mla with the MoE FFN; mlstm and slstm; the encoder's
# attn_bidir and cross attention; the embedding frontend stub
LM_ARCHS = ("qwen3-4b", "recurrentgemma-2b", "deepseek-v2-236b",
            "xlstm-350m", "whisper-small", "chameleon-34b")
LM_REL = 1e-4   # of max|CPU logits|, float32 with TF32 off


def _lm_batch(model, B, S, seed):
    from repro_torch.data.tokens import synthetic_lm_batches
    cfg = model.cfg
    toks = torch.as_tensor(next(synthetic_lm_batches(
        cfg.vocab_size, B, S, seed=seed))["tokens"])
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": toks} if cfg.frontend == "none" else \
        {"embeds": torch.randn((B, S, cfg.d_model), generator=gen)}
    if cfg.encoder_layers:
        batch["enc_embeds"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                          generator=gen)
    return batch


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_reduced_on_card_matches_cpu(cuda, arch):
    """Prefill logits and 3 decode steps (the CPU's greedy tokens fed to
    both) of one set of weights on the card and on the CPU."""
    from repro_torch.configs import load_all
    from repro_torch.configs.shapes import reduced_config
    from repro_torch.models import Model
    load_all()
    cpu = Model.init(reduced_config(arch), torch.Generator().manual_seed(0),
                     device="cpu")
    card = Model.from_params(cpu.cfg, cpu.tree(), device=cuda)
    batch = _lm_batch(cpu, 2, 10, seed=1)
    want, wc = cpu.prefill(batch, cache_len=13)
    got, gc = card.prefill({k: v.to(cuda) for k, v in batch.items()},
                           cache_len=13)
    assert got.device.type == "cuda"
    assert _rel(got.cpu(), want) < LM_REL
    for t in range(3):
        tok = want[:, -1].argmax(-1)[:, None]
        want, wc = cpu.decode_step(tok, wc, 10 + t)
        got, gc = card.decode_step(tok.to(cuda), gc, 10 + t)
        assert _rel(got.cpu(), want) < LM_REL, t


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen3-4b",
                                  "recurrentgemma-2b"])
def test_lm_mesh_one_rank_nccl_matches_cpu(cuda, arch, tmp_path):
    """A (1, 1) mesh over a one-rank NCCL group on the card: prefill logits,
    the caches (DTensors, placed by cache_axes) and 3 decode steps equal the
    CPU's no-mesh run of the same weights (rel 1e-4)."""
    import datetime
    import torch.distributed as dist
    from repro_torch.configs import load_all
    from repro_torch.configs.shapes import reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    load_all()
    cpu = Model.init(reduced_config(arch), torch.Generator().manual_seed(0),
                     device="cpu")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh("cuda")
        card = Model.from_params(cpu.cfg, cpu.tree(), mesh=mesh)
        batch = _lm_batch(cpu, 2, 10, seed=1)
        want, wc = cpu.prefill(batch, cache_len=13)
        got, gc = card.prefill({k: v.to(cuda) for k, v in batch.items()},
                               cache_len=13)
        assert got.device.type == "cuda"
        assert _rel(got.cpu(), want) < LM_REL
        for t in range(3):
            tok = want[:, -1].argmax(-1)[:, None]
            want, wc = cpu.decode_step(tok, wc, 10 + t)
            got, gc = card.decode_step(tok.to(cuda), gc, 10 + t)
            assert _rel(got.cpu(), want) < LM_REL, t
    finally:
        dist.destroy_process_group()


def test_lm_model_and_example_default_to_cuda(cuda):
    """Model.init and the serving example's entry point without a device
    run on the card."""
    import importlib.util
    import os
    from repro_torch.configs import load_all
    from repro_torch.configs.shapes import reduced_config
    from repro_torch.models import Model
    load_all()
    model = Model.init(reduced_config("qwen3-4b"))
    assert model.device.type == "cuda"
    assert all(p.device.type == "cuda" for p in model.parameters())
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "examples", "serve_lm_torch.py")
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve)
    toks, stats = serve.main(["--reduced", "--batch", "2", "--prompt-len", "8",
                              "--gen", "3"])
    assert toks.shape == (2, 3) and stats["decode_tok_per_s"] > 0


# ---------------------------------------------------------------------------
# The LM plane's training path (repro_torch.train) on the card
# ---------------------------------------------------------------------------

LM_TRAIN_REL = 1e-4   # of each leaf's max, float32 with TF32 off


def _train_step_on(model, batch, remat_policy="dots"):
    from repro_torch.models import transformer
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_step import init_train_state
    # eps 1e-4 bounds Adam's first-step amplification of a gradient's
    # rounding at 1e4 (tests/test_torch_train.py)
    oc = AdamWConfig(lr=1e-3, warmup_steps=20, eps=1e-4)
    transformer.set_remat_policy(remat_policy)
    state, metrics = make_train_step(model, oc, microbatches=2, remat=True)(
        init_train_state(model, oc), batch)
    return state, float(metrics["loss"])


@pytest.mark.parametrize("arch", [
    "xlstm-350m", "recurrentgemma-2b", "qwen2.5-14b", "qwen1.5-32b", "yi-34b",
    "qwen3-4b", "kimi-k2-1t-a32b", "deepseek-v2-236b", "chameleon-34b",
    "whisper-small"])
def test_lm_train_step_on_card_matches_cpu(cuda, arch):
    """One train step (2 microbatches, "dots" remat) of one set of weights on
    the card and on the CPU: the loss, every updated parameter and every
    moment."""
    from repro_torch.configs import load_all
    from repro_torch.configs.shapes import reduced_config
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    load_all()
    cpu = Model.init(reduced_config(arch), torch.Generator().manual_seed(0),
                     device="cpu")
    card = Model.from_params(cpu.cfg, cpu.tree(), device=cuda)
    batch = _lm_batch(cpu, 4, 16, seed=2)
    batch["labels"] = torch.randint(0, cpu.cfg.vocab_size, (4, 16),
                                    generator=torch.Generator().manual_seed(3))
    want, wl = _train_step_on(cpu, batch)
    got, gl = _train_step_on(card, {k: v.to(cuda) for k, v in batch.items()})
    assert abs(gl - wl) <= LM_TRAIN_REL * abs(wl)
    for part in ("params", "opt"):
        for g, w in zip(tree_leaves(got[part]), tree_leaves(want[part]),
                        strict=True):
            if g.dtype.is_floating_point:
                assert g.device.type == "cuda"
                assert _rel(g.detach().cpu(), w.detach()) < LM_TRAIN_REL, part


def test_lm_train_loop_resume_on_card_bit_for_bit(cuda, tmp_path):
    """train_loop on the card: 30 steps with a checkpoint every 10, then a
    resume to 45, against an uninterrupted 45-step run."""
    from repro_torch.configs import load_all
    from repro_torch.configs.shapes import reduced_config
    from repro_torch.launch.train import train_loop
    load_all()
    cfg = reduced_config("qwen3-4b")
    run = dict(batch_size=4, seq_len=32, dp=None, microbatches=2,
               ckpt_every=10, device="cuda")
    _, whole = train_loop(cfg, steps=45, ckpt_dir=str(tmp_path / "a"),
                          resume=False, **run)
    _, first = train_loop(cfg, steps=30, ckpt_dir=str(tmp_path / "b"),
                          resume=False, **run)
    _, rest = train_loop(cfg, steps=45, ckpt_dir=str(tmp_path / "b"),
                         resume=True, **run)
    assert first + rest == whole
