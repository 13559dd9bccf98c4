r"""Fused Kronecker-chain kernel: a whole factor chain per launch.

:func:`fused_chain_matvec` applies ``⊗_i S_i`` to every row of a stack
``X (B, Π n_i)`` in ONE launch of the hand-written CUDA kernel
``csrc/fused_chain.cu``: a block loads a few rows into shared memory once,
contracts them axis by axis between two on-chip buffers, and writes the
result at its true width.  It replaces the JAX package's Pallas kernel
(``repro/kernels/kron_matvec/fused.py``: ``_make_fused_kernel``,
``_build_fused_call``); the source file says what bounds it and how.

:func:`plan_chain` replaces the JAX package's VMEM budget with the Hopper
shared-memory budget: the factors plus two ping-pong buffers per row, each
as wide as the chain's largest intermediate, must fit the 227 KB one block
may use.  A chain that does not fit even one row (``fused_ok=False``) goes to
the per-axis kernel (ops.py), as the JAX package's ``_fallback_per_axis``
does.  The TPU's (8, 128) tiling does not apply, so there is no pad and no
slice.  Launch parameters are fixed (below); there is no autotuner yet.

CPU tensors take :func:`fused_chain_matvec_plain`, which runs the per-axis
plain version axis by axis: the same sum in the same order as the kernel.

The ``'cumsum'`` epilogue (an inclusive prefix sum along marked axes after
the chain, ResidualPlanner+'s implicit prefix matrix) runs inside the fused
kernel.  Where the JAX package applies it with ``jnp.cumsum`` outside Pallas
(the per-axis fallback, a chain with no live factor) the port applies
:func:`apply_epilogue`, ``torch.cumsum``.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._build import load
from ._layout import normalize_factor
from .kron_matvec import kron_axis_matvec_plain
from .ops import per_axis_chain
from .stats import CHAIN_STATS

_SMEM_BUDGET = 232448   # 227 KB of shared memory per Hopper block
_TARGET_FLOATS = 4096   # aim for this many floats per buffer per block
_MAX_AXES = 16          # fused_chain.cu's kMaxAxes


@dataclass(frozen=True)
class ChainPlan:
    """Static launch plan for one fused chain."""

    in_dims: Tuple[int, ...]                        # per-axis input sizes n_i
    fshapes: Tuple[Optional[Tuple[int, int]], ...]  # (m_i, n_i) or None (identity)
    out_dims: Tuple[int, ...]                       # per-axis output sizes
    n_in: int                                       # prod(in_dims)
    n_out: int                                      # prod(out_dims)
    buf: int           # floats of one ping-pong buffer: the widest intermediate
    rows: int          # batch rows per block
    smem_bytes: int    # factors + 2 * rows * buf floats
    fused_ok: bool     # fits the shared-memory budget?
    epilogue: Tuple[Optional[str], ...] = ()        # per-axis 'cumsum' or None

    @property
    def signature(self) -> tuple:
        return (self.in_dims, self.fshapes, self.epilogue)


def plan_chain(factors: Sequence, dims: Sequence[int], batch: int = 1,
               smem_budget: Optional[int] = None,
               epilogue: Optional[Sequence[Optional[str]]] = None) -> ChainPlan:
    """Plan the fused launch of ``(⊗_i factors[i])`` on a (batch, N) stack.

    ``rows`` starts from about ``_TARGET_FLOATS`` floats of work per buffer
    and shrinks until the factors and both buffers fit ``smem_budget``
    (default: the 227 KB a Hopper block may use).  ``epilogue[i]`` is
    ``'cumsum'`` or None per axis; the kernel scans in place, so it changes
    neither ``rows`` nor ``fused_ok``.
    """
    budget = _SMEM_BUDGET if smem_budget is None else int(smem_budget)
    dims = tuple(int(d) for d in dims)
    epilogue = tuple(epilogue) if epilogue is not None else (None,) * len(dims)
    if len(epilogue) != len(dims):
        raise ValueError(f"epilogue length {len(epilogue)} != {len(dims)} axes")
    if any(op not in (None, "cumsum") for op in epilogue):
        raise ValueError(f"unknown epilogue op in {epilogue}")
    specs: List[Optional[Tuple[int, int]]] = []
    out_dims: List[int] = []
    for f, n in zip(factors, dims):
        s = normalize_factor(f, n)
        if s is None:
            specs.append(None)
            out_dims.append(n)
        else:
            if s.shape[1] != n:
                raise ValueError(f"factor {s.shape} does not match axis size {n}")
            specs.append((int(s.shape[0]), n))
            out_dims.append(int(s.shape[0]))
    n_in = math.prod(dims)
    n_out = math.prod(out_dims)
    sizes = [n_in]
    cur = list(dims)
    for axis, spec in enumerate(specs):
        if spec is not None:
            cur[axis] = spec[0]
            sizes.append(math.prod(cur))
    buf = max(sizes)
    nf = sum(m * n for s in specs if s is not None for m, n in [s])
    fit = (budget - 4 * nf) // (8 * buf)
    rows = max(1, min(fit, max(int(batch), 1), max(1, _TARGET_FLOATS // buf)))
    fused_ok = fit >= 1 and len(dims) <= _MAX_AXES
    return ChainPlan(dims, tuple(specs), tuple(out_dims), n_in, n_out, buf,
                     rows, 4 * (nf + 2 * rows * buf), fused_ok, epilogue)


def _lib():
    lib = load("fused_chain")
    fn = lib.fused_chain_launch
    if fn.argtypes is None:
        ip = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ip, ip, ip, ip,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def apply_epilogue(y: torch.Tensor, out_dims: Sequence[int],
                   epilogue: Optional[Sequence[Optional[str]]]) -> torch.Tensor:
    """``torch.cumsum`` along the marked axes of a (B, Π out_dims) stack.

    The epilogue of the routes that do not run it in the fused kernel: the
    per-axis fallback, a chain with no live factor, and the plain version.
    """
    if not epilogue or all(op is None for op in epilogue):
        return y
    b = y.shape[0]
    t = y.reshape((b,) + tuple(out_dims))
    for axis, op in enumerate(epilogue):
        if op == "cumsum":
            t = torch.cumsum(t, dim=axis + 1)
    return t.reshape(b, -1)


def fused_chain_matvec_plain(s_facs: Sequence, x: torch.Tensor,
                             dims: Sequence[int],
                             epilogue: Optional[Sequence[Optional[str]]] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version: the per-axis plain version on each live axis,
    then :func:`apply_epilogue`."""
    b = x.shape[0]
    y = per_axis_chain(s_facs, x.reshape(-1), dims, b,
                       kron_axis_matvec_plain).reshape(b, -1)
    out_dims = [n if s is None else s.shape[0]
                for s, n in zip(map(normalize_factor, s_facs, dims), dims)]
    return apply_epilogue(y, out_dims, epilogue)


def _launch(plan: ChainPlan, s_facs: Sequence[Optional[np.ndarray]],
            x: torch.Tensor) -> torch.Tensor:
    b = x.shape[0]
    k = len(plan.in_dims)
    live = [s for s in s_facs if s is not None]
    offs, pos = [], 0
    for s in s_facs:
        offs.append(-1 if s is None else pos)
        pos += 0 if s is None else s.size
    f = torch.as_tensor(np.concatenate([s.ravel() for s in live]),
                        dtype=torch.float32, device=x.device)
    epi = [int(op == "cumsum") for op in plan.epilogue]
    arr = ctypes.c_int * k
    y = torch.empty((b, plan.n_out), dtype=torch.float32, device=x.device)
    if b == 0:
        return y
    with torch.cuda.device(x.device):
        rc = _lib()(x.data_ptr(), y.data_ptr(), f.data_ptr(), b, k,
                    arr(*plan.in_dims), arr(*plan.out_dims), arr(*offs),
                    arr(*epi), pos, plan.rows, plan.buf,
                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_chain kernel launch failed: CUDA error {rc}")
    CHAIN_STATS.inc("fused_launches")
    if any(epi):
        CHAIN_STATS.inc("epilogue_launches")
    return y


def _fallback_per_axis(s_facs: Sequence[Optional[np.ndarray]],
                       x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """Per-axis kernel on the batched stack: identity on the batch axis."""
    b = x.shape[0]
    return per_axis_chain(s_facs, x.reshape(-1), dims, b).reshape(b, -1)


def fused_chain_matvec(factors: Sequence, x: torch.Tensor, dims: Sequence[int],
                       smem_budget: Optional[int] = None,
                       epilogue: Optional[Sequence[Optional[str]]] = None,
                       compute_dtype: Optional[str] = None) -> torch.Tensor:
    """Apply ``⊗_i factors[i]`` to a stack ``x`` of shape (B, N) (or flat (N,)).

    One launch of the fused kernel per chain on CUDA tensors; chains over the
    shared-memory budget go to the per-axis kernel.  CPU tensors take the
    plain version.  ``epilogue[i] == 'cumsum'`` adds an inclusive prefix sum
    along output axis i after the chain: in the fused kernel, or with
    :func:`apply_epilogue` on the fallback and when no factor is live.
    Returns float32 of shape (B, n_out), or (n_out,) for a flat input.
    Narrow compute dtypes of the JAX package are not ported yet and raise.
    """
    if compute_dtype not in (None, "float32"):
        raise NotImplementedError("narrow compute dtypes are not ported yet "
                                  "(ROADMAP queue 2, fused kernel slice c)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if len(factors) != len(dims):
        raise ValueError(f"{len(factors)} factors for {len(dims)} axes")
    x = x.to(torch.float32)
    flat_in = x.dim() == 1
    if flat_in:
        x = x[None, :]
    b = x.shape[0]
    s_facs = [normalize_factor(f, n) for f, n in zip(factors, dims)]
    plan = plan_chain(s_facs, dims, batch=b, smem_budget=smem_budget,
                      epilogue=epilogue)
    if x.shape[1] != plan.n_in:
        raise ValueError(f"x width {x.shape[1]} != prod(dims) {plan.n_in}")
    n_epi = sum(op is not None for op in plan.epilogue)
    if all(s is None for s in s_facs):
        if not n_epi:
            return x[0] if flat_in else x
        y = apply_epilogue(x, plan.out_dims, plan.epilogue)
    elif not plan.fused_ok:
        CHAIN_STATS.inc("fallback_chains")
        y = _fallback_per_axis(s_facs, x, plan.in_dims)
        y = apply_epilogue(y, plan.out_dims, plan.epilogue)
    else:
        CHAIN_STATS.inc("fused_chains")
        if x.device.type == "cpu":
            y = fused_chain_matvec_plain(s_facs, x, plan.in_dims,
                                         plan.epilogue)
        else:
            y = _launch(plan, s_facs, x.contiguous())
    CHAIN_STATS.inc("epilogue_axes", n_epi)
    return y[0] if flat_in else y
