r"""Per-axis Kronecker factor kernel: ``o[l, m, r] = Σ_n S[m, n] · x[l, n, r]``.

Every ResidualPlanner phase reduces to chains of ``y = (I_L ⊗ S ⊗ I_R) x``: view
x as (L, n, R) and contract the small per-attribute matrix S (m, n) with the
middle axis.  :func:`kron_axis_matvec` launches the hand-written CUDA kernel
``csrc/kron_axis.cu`` on CUDA tensors and runs :func:`kron_axis_matvec_plain`
on CPU tensors.  It replaces the JAX package's Pallas kernel
(``repro/kernels/kron_matvec/kron_matvec.py``: ``_kron_axis_kernel``,
``kron_axis_matvec``); the source file says what bounds it and how.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .._build import load
from .stats import CHAIN_STATS

# The kernel's tile (kron_axis.cu's Tile): 128 threads, each an 8 x 4
# micro-tile; wq warps along q (32 q each) by 4 / wq along the columns (32
# columns each); k staged 8 at a time.
_BK, _TM, _TN = 8, 8, 4


@dataclass(frozen=True)
class AxisGeometry:
    """The launch of one per-axis kernel call: tile sizes, 2-D grid
    (q tiles, column tiles) and static shared memory."""

    bm: int
    bn: int
    bk: int
    tm: int
    tn: int
    grid_q: int        # tiles of q: blockIdx.y
    grid_c: int        # tiles of the L * R columns: blockIdx.x
    smem_bytes: int    # S and x chunks and the result tile, float32

    @property
    def blocks(self) -> int:
        return self.grid_q * self.grid_c

    @property
    def threads(self) -> int:
        return (self.bm // self.tm) * (self.bn // self.tn)


def axis_geometry(L: int, n: int, R: int, m: int) -> AxisGeometry:
    """Geometry of ``o (L, m, R) = S (m, n) · x (L, n, R)``.

    The tile follows m: 128 q by 32 columns when m > 64 (x read once, many
    narrow tiles), 64 by 64 when m > 32, else 32 by 128.  Every shape fits:
    k is staged in chunks, so shared memory does not grow with S.
    """
    wq = 4 if m > 64 else 2 if m > 32 else 1
    bm, bn = 32 * wq, 32 * (4 // wq)
    smem = 4 * (_BK * (bm + 4) + _BK * (bn + 4) + bn * (bm + 1))
    return AxisGeometry(bm, bn, _BK, _TM, _TN, -(-int(m) // bm),
                        -(-int(L) * int(R) // bn), smem)


def _lib():
    lib = load("kron_axis")
    fn = lib.kron_axis_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kron_axis_matvec_plain(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same sum, term by term in k order.

    Each step is one multiply and one add, each rounded on its own, so the
    result does not depend on the layout of x: a chain run axis by axis here
    and the same chain run by the fused kernel's plain version agree bit for
    bit.
    """
    m, n = s.shape
    acc = s[:, 0].view(1, m, 1) * x[:, 0:1, :]
    for k in range(1, n):
        acc = acc + s[:, k].view(1, m, 1) * x[:, k:k + 1, :]
    return acc


def kron_axis_matvec(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply S (m, n) along the middle axis of x (L, n, R) → (L, m, R), fp32.

    CUDA tensors launch ``csrc/kron_axis.cu``; CPU tensors take the plain
    version.  Raises on anything else, and if the launch fails.
    """
    if s.dim() != 2 or x.dim() != 3 or s.shape[1] != x.shape[1]:
        raise ValueError(f"bad shapes S {tuple(s.shape)}, x {tuple(x.shape)}")
    if s.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("kron_axis_matvec takes float32 tensors")
    if s.device != x.device:
        raise ValueError(f"S on {s.device}, x on {x.device}")
    if x.device.type == "cpu":
        return kron_axis_matvec_plain(s, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    L, n, R = x.shape
    m = s.shape[0]
    g = axis_geometry(L, n, R, m)
    s = s.contiguous()
    x = x.contiguous()
    out = torch.empty((L, m, R), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _lib()(s.data_ptr(), x.data_ptr(), out.data_ptr(), L, n, R, m,
                    g.bm, g.bn, g.bk, g.grid_q, g.grid_c, g.smem_bytes,
                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kron_axis kernel launch failed: CUDA error {rc}")
    CHAIN_STATS.inc("axis_launches")
    return out
