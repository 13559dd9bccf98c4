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

import torch

from .._build import load
from .stats import CHAIN_STATS

_TILE = 128                 # (l, r) columns per block; halved until S fits
_MIN_TILE = 32
_SMEM_MAX = 232448          # 227 KB: what one Hopper block may use


def _axis_smem_bytes(n: int, m: int, tile: int) -> int:
    """Shared memory of one launch: S (m, n) plus the (n, tile + 1) slab."""
    return 4 * (m * n + n * (tile + 1))


def axis_tile(n: int, m: int) -> int:
    """Columns per block for an (m, n) factor; raises if S cannot fit."""
    tile = _TILE
    while _axis_smem_bytes(n, m, tile) > _SMEM_MAX and tile > _MIN_TILE:
        tile //= 2
    if _axis_smem_bytes(n, m, tile) > _SMEM_MAX:
        raise ValueError(f"factor ({m}, {n}) does not fit a block's shared "
                         f"memory ({_SMEM_MAX} bytes)")
    return tile


def _lib():
    lib = load("kron_axis")
    fn = lib.kron_axis_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    tile = axis_tile(n, m)
    s = s.contiguous()
    x = x.contiguous()
    out = torch.empty((L, m, R), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _lib()(s.data_ptr(), x.data_ptr(), out.data_ptr(), L, n, R, m,
                    tile, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kron_axis kernel launch failed: CUDA error {rc}")
    CHAIN_STATS.inc("axis_launches")
    return out
