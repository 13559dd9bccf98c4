"""Launch geometry of the port's two CUDA kernels, walked on the CPU.

The kernels (``csrc/fused_chain.cu``, ``csrc/kron_axis.cu``) cannot run here,
but the arithmetic that maps their threads to work lives in Python
(``fused_geometry`` / ``pack_factors`` in fused.py, ``axis_geometry`` in
kron_matvec.py) and is passed to the launchers.  Each test below walks a
kernel's tiling in numpy with the kernel's own index formulas (block,
thread, staging slot, line, micro-tile), checks that every output is
written exactly once and every staged slot filled once, and compares what
the walk computes in float64 with the JAX package's float64 oracle
(``kron_matvec_np``), to rel 1e-12.
"""
import math

import numpy as np
import pytest

from repro.core.kron import kron_matvec_np

from repro_torch.core import Domain, all_kway
from repro_torch.core.mechanism import signature_groups
from repro_torch.core.reconstruct import u_chain_factors
from repro_torch.core.residual import sub_matrix
from repro_torch.data.tabular import adult_domain, synth_domain
from repro_torch.kernels.kron_matvec.fused import (_EXACT_CAP, axis_cap,
                                                   fused_geometry,
                                                   pack_factors, pad4,
                                                   plan_chain)
from repro_torch.kernels.kron_matvec.kron_matvec import axis_geometry

SMEM_MAX = 232448       # 227 KB: what one Hopper block may use
SMEM_DEFAULT = 49152    # dynamic shared memory without the attribute
THREADS = 256           # fused_chain.cu's kThreads
AXIS_THREADS = 128      # kron_axis.cu's kThreads
H100_SMS = 132


def _rel(got, want):
    return np.max(np.abs(got - want)) / max(np.abs(want).max(), 1e-300)


# ------------------------------------------------------------------ per axis
def walk_axis(s: np.ndarray, x: np.ndarray):
    """kron_axis.cu's tiling on S (m, n), x (L, n, R): staging slots of
    every k chunk, the micro-tile of every thread, the result tile in shared
    memory and the stores out of it.  Returns (o, writes per output)."""
    L, n, R = x.shape
    m = s.shape[0]
    g = axis_geometry(L, n, R, m)
    threads = g.threads
    assert threads == AXIS_THREADS
    wc = g.bn // 32                      # warps along the columns
    cols = L * R
    xf, sf = x.reshape(-1), s.reshape(-1)
    o = np.zeros(L * m * R)
    writes = np.zeros(L * m * R, dtype=int)
    tid = np.arange(threads)
    lane, warp = tid % 32, tid // 32
    wq_, wc_ = warp // wc, warp % wc
    tq = wq_ * 32 + (lane // 8) * g.tm
    tcol = wc_ * 32 + (lane % 8) * g.tn
    for by in range(g.grid_q):
        q0 = by * g.bm
        live = q0 + wq_ * 32 < m
        for bx in range(g.grid_c):
            c0 = bx * g.bn
            acc = np.zeros((g.bm, g.bn))
            for k0 in range(0, n, g.bk):
                a_s = np.full((g.bk, g.bm), np.nan)
                b_s = np.full((g.bk, g.bn), np.nan)
                for t in range(g.bm * g.bk // threads):
                    q, kk = tid // g.bk + t * (threads // g.bk), tid % g.bk
                    ok = (q0 + q < m) & (k0 + kk < n)
                    assert np.isnan(a_s[kk, q]).all()
                    a_s[kk, q] = np.where(
                        ok, sf[np.where(ok, (q0 + q) * n + k0 + kk, 0)], 0.0)
                for t in range(g.bn * g.bk // threads):
                    if R == 1:
                        j = tid // g.bk + t * (threads // g.bk)
                        kk = tid % g.bk
                        c, k = c0 + j, k0 + kk
                        idx = c * n + k
                    else:
                        j = tid % g.bn
                        kk = tid // g.bn + t * (threads // g.bn)
                        c, k = c0 + j, k0 + kk
                        l = c // R
                        idx = l * n * R + (c - l * R) + k * R
                    ok = (c < cols) & (k < n)
                    assert np.isnan(b_s[kk, j]).all()
                    b_s[kk, j] = np.where(ok, xf[np.where(ok, idx, 0)], 0.0)
                assert not np.isnan(a_s).any() and not np.isnan(b_s).any()
                acc += a_s.T @ b_s
            # each live thread's micro-tile into the result tile Cs[col][q]
            cs = np.full((g.bn, g.bm), np.nan)
            for i in range(g.tm):
                for j in range(g.tn):
                    assert np.isnan(cs[(tcol + j)[live], (tq + i)[live]]).all()
                    cs[(tcol + j)[live], (tq + i)[live]] = \
                        acc[(tq + i)[live], (tcol + j)[live]]
            qn = min(m - q0, g.bm)
            assert not np.isnan(cs[:, :qn]).any()
            if R == 1:
                for start in range(0, g.bn * g.bm, threads):
                    idx = start + tid
                    col, q = idx // g.bm, idx % g.bm
                    c = c0 + col
                    ok = (c < cols) & (q < qn)
                    dst = (c * m + q0 + q)[ok]
                    np.add.at(writes, dst, 1)
                    o[dst] = cs[col[ok], q[ok]]
            else:
                col = tid % g.bn
                c = c0 + col
                l = c // R
                for q in range(0, g.bm, threads // g.bn):
                    qq = q + tid // g.bn
                    ok = (c < cols) & (qq < qn)
                    dst = ((l * m + q0 + qq) * R + (c - l * R))[ok]
                    np.add.at(writes, dst, 1)
                    o[dst] = cs[col[ok], qq[ok]]
    return o.reshape(L, m, R), writes


AXIS_SHAPES = [
    (1, 17, 1, 1), (3, 33, 1, 3), (7, 16, 129, 8), (2, 130, 3, 65),
    (300, 5, 1, 130), (1, 200, 2, 9), (5, 2, 7001, 2), (4, 100, 1, 99),
    (3, 9, 5, 40), (33, 10, 1, 64),
]


@pytest.mark.parametrize("L,n,R,m", AXIS_SHAPES)
def test_axis_tiling_covers_every_output_once(L, n, R, m):
    """Each tile shape (m <= 32, <= 64, above), m below a lane row's 8 q and
    above one 128-q tile, n over several 8-value chunks, L * R off the
    tile's columns, R == 1 and R > 1."""
    rng = np.random.default_rng(L * 1000 + n)
    s = rng.standard_normal((m, n))
    x = rng.standard_normal((L, n, R))
    o, writes = walk_axis(s, x)
    assert (writes == 1).all()
    want = kron_matvec_np([None, s, None], x.reshape(-1), (L, n, R))
    assert _rel(o.reshape(-1), want) < 1e-12


def test_axis_geometry_needs_no_large_shared_memory():
    """k is staged in chunks: shared memory does not grow with the factor,
    and stays under the default 48 KB (no attribute to set)."""
    sizes = {axis_geometry(L, n, R, m).smem_bytes
             for L, n, R, m in AXIS_SHAPES + [(1, 4096, 1, 4096)]}
    assert len(sizes) == 3 and max(sizes) <= SMEM_DEFAULT


def test_adult_widest_chain_fills_every_sm_twice():
    """Adult's (100,100,100) measure chain on 2 rows: each of its three
    per-axis launches gives at least 2 blocks per H100 SM."""
    cur = [2, 100, 100, 100]
    for axis in (1, 2, 3):
        g = axis_geometry(math.prod(cur[:axis]), 100,
                          math.prod(cur[axis + 1:]), 99)
        assert g.blocks >= 2 * H100_SMS, (axis, g)
        cur[axis] = 99


# ---------------------------------------------------------------- fused chain
def walk_fused(plan, facs, x: np.ndarray):
    """fused_chain.cu's tiling of ``plan`` on x (B, n_in): per block the
    dense staging, per live axis the lines (one thread each), then the
    epilogue's lines.  Returns y (B, n_out); asserts every intermediate
    element is written once and fits a buffer."""
    geo = fused_geometry(plan)
    f = pack_factors(plan, facs).astype(np.float64)
    b, rows = x.shape[0], plan.rows
    y = np.full((b, plan.n_out), np.nan)
    for r0 in range(0, b, rows):
        nr = min(rows, b - r0)
        src = x[r0:r0 + nr].reshape(-1).copy()    # one contiguous span
        for ax in geo:
            if ax.off < 0:
                continue
            ld = pad4(ax.n)
            s = f[ax.off:ax.off + ax.m * ld].reshape(ax.m, ld)
            assert not s[:, ax.n:].any()                # the padding is 0
            assert ax.cap in (ax.n, 0)
            line = np.arange(ax.lines(nr))
            assert line.size == nr * ax.pre * ax.post
            if ax.cap:                   # a line a thread, all m outputs
                item_line = line
                item_q = np.zeros_like(line)
                qs = ax.m
            else:                        # 4 outputs of a line a thread
                item = np.arange(ax.items(nr))
                item_line, item_q = item % line.size, 4 * (item // line.size)
                qs = 4
            o, t = item_line // ax.post, item_line % ax.post
            xr = np.zeros((item_line.size, ld))        # inputs past n: 0
            xr[:, :ax.n] = src[(o * ax.n * ax.post + t)[:, None]
                               + np.arange(ax.n) * ax.post]
            q = item_q[:, None] + np.arange(qs)
            live = q < ax.m
            out = (o * ax.m * ax.post + t)[:, None] + q * ax.post
            dst = np.full(nr * ax.pre * ax.m * ax.post, np.nan)
            writes = np.zeros(dst.size, dtype=int)
            np.add.at(writes, out[live], 1)
            vals = np.einsum("ik,iqk->iq", xr,
                             s[np.minimum(q, ax.m - 1)])
            dst[out[live]] = vals[live]
            assert (writes == 1).all() and dst.size <= rows * plan.buf
            src = dst
        for ax in geo:
            if not ax.epi:
                continue
            line = np.arange(nr * ax.pre * ax.epost)
            o, t = line // ax.epost, line % ax.epost
            idx = (o * ax.m * ax.epost + t)[:, None] + np.arange(ax.m) * ax.epost
            seen = np.zeros(src.size, dtype=int)
            np.add.at(seen, idx, 1)
            assert (seen == 1).all()
            src[idx] = np.cumsum(src[idx], axis=1)
        y[r0:r0 + nr] = src.reshape(nr, -1)
    return y


# (dims, factor shapes (None: identity), batch, rows, epilogue): register
# axes (n <= 16) and streamed ones (n = 17 to 130, m not a multiple of 4),
# identity axes, 'cumsum' axes, a ragged last block.
FUSED_CASES = [
    ((10, 10, 10), [(9, 10)] * 3, 9, 4, None),
    ((10, 10, 10), [(10, 10)] * 3, 7, 2, ("cumsum",) * 3),
    ((17, 6), [(5, 17), (6, 6)], 9, 4, None),
    ((3, 7), [(2, 3), None], 13, 3, None),
    ((40, 5), [None, (3, 5)], 7, 2, ("cumsum", None)),
    ((2, 100), [(1, 2), (99, 100)], 5, 2, None),
    ((130,), [(7, 130)], 33, 8, None),
    ((5, 7, 9), [(5, 5), None, (4, 9)], 31, 5, ("cumsum", "cumsum", None)),
    ((1, 16, 3), [(2, 1), (16, 16), (1, 3)], 11, 4, (None, "cumsum", None)),
]


@pytest.mark.parametrize("dims,shapes,batch,rows,epi", FUSED_CASES)
def test_fused_tiling_covers_every_output_once(dims, shapes, batch, rows, epi):
    rng = np.random.default_rng(sum(dims) + batch)
    facs = [None if sh is None else rng.standard_normal(sh) for sh in shapes]
    x = rng.standard_normal((batch, math.prod(dims)))
    plan = plan_chain(facs, dims, batch=batch, rows=rows, epilogue=epi)
    assert plan.fused_ok
    y = walk_fused(plan, [None if f is None else f.astype(np.float32)
                          for f in facs], x)
    f32 = [None if f is None else f.astype(np.float32).astype(np.float64)
           for f in facs]
    want = np.stack([kron_matvec_np(f32, row, dims) for row in x])
    if epi:
        t = want.reshape((batch,) + plan.out_dims)
        for a, op in enumerate(epi):
            if op:
                t = np.cumsum(t, axis=a + 1)
        want = t.reshape(batch, -1)
    assert _rel(y, want) < 1e-12


def test_fused_geometry_records():
    """The launcher's checks, on the Python side: pre / post / epost are the
    products around each axis, caps hold their axis, factors are packed at
    4-aligned offsets without overlap, and nf counts the padded rows."""
    for dims, shapes, batch, rows, epi in FUSED_CASES:
        facs = [None if sh is None else np.ones(sh) for sh in shapes]
        plan = plan_chain(facs, dims, batch=batch, rows=rows, epilogue=epi)
        geo = fused_geometry(plan)
        end = 0
        for a, ax in enumerate(geo):
            assert ax.pre == math.prod(plan.out_dims[:a])
            assert ax.post == math.prod(plan.in_dims[a + 1:])
            assert ax.epost == math.prod(plan.out_dims[a + 1:])
            assert ax.epi == int(bool(epi and epi[a]))
            if ax.off < 0:
                assert shapes[a] is None and ax.cap == 0
                continue
            assert ax.off == end and ax.off % 4 == 0
            end += ax.m * pad4(ax.n)
            assert ax.cap == axis_cap(ax.n)
            assert ax.items(rows) == ax.lines(rows) * (1 if ax.cap else
                                                      -(-ax.m // 4))
        assert end == plan.nf
    assert [axis_cap(n) for n in (1, 10, 16, 17, 100, 129)] \
        == [1, 10, 16, 0, 0, 0]
    assert _EXACT_CAP == 16


# ------------------------------------------------------- main-path chains
def _main_path_chains():
    """(label, factors, dims, batch) of every measure and reconstruct chain
    of the Adult and Synth-10^100 <=3-way releases."""
    out = []
    for label, dom in (("adult", adult_domain()),
                       ("synth", synth_domain(10, 100))):
        cliques = all_kway(dom, 3, include_lower=True).cliques
        for dims, cl in signature_groups(dom, cliques).items():
            if dims:
                out.append((label, [sub_matrix(n) for n in dims], dims,
                            2 * len(cl)))
                out.append((label, u_chain_factors(dom, cl[0]), dims, len(cl)))
    return out


def test_every_main_path_chain_fits_a_block():
    """Each chain of the two releases fits 232,448 bytes: on the fused
    kernel when plan_chain fits it, else axis by axis on the per-axis
    kernel, whose grid stays inside CUDA's limits."""
    chains = _main_path_chains()
    assert len(chains) > 100
    fused = 0
    for label, facs, dims, batch in chains:
        plan = plan_chain(facs, dims, batch=batch)
        if plan.fused_ok:
            fused += 1
            assert plan.smem_bytes <= SMEM_MAX
            continue
        cur = [batch] + list(dims)
        for axis, f in enumerate(facs, start=1):
            m, n = np.asarray(f).shape
            g = axis_geometry(math.prod(cur[:axis]), n,
                              math.prod(cur[axis + 1:]), m)
            assert g.smem_bytes <= SMEM_MAX and g.grid_q <= 65535
            assert g.grid_c < 2 ** 31
            cur[axis] = m
    assert 0 < fused < len(chains)


def test_domain_chain_dims_cover_both_paths():
    """Adult's attribute sizes take both contractions; Synth's 10 the
    register one."""
    caps = {axis_cap(n) for n in Domain.create([100, 42, 16, 2]).sizes}
    assert caps == {0, 16, 2}
    assert axis_cap(10) == 10
