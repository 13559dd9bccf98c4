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
slice.

Operands may be narrow (``compute_dtype`` bfloat16 or float16, float32
accumulation, as in the JAX package): the kernel then holds the factors and
both buffers at two bytes an element, so more rows fit a block.  The stack
is still read and written as float32.

Launch parameters (``rows``, ``smem_budget``, ``compute_dtype``) passed
explicitly are used as given; otherwise the autotuner
(``repro_torch.kernels.autotune``, ``REPRO_KERNEL_AUTOTUNE``) resolves them
for the chain, and a tuned ``fused=False`` sends the chain to the per-axis
kernel.  ``allow_narrow`` gates narrow operands: call sites that carry
Gaussian noise keep it False, and a tuned narrow config is then re-planned
at float32, rows and fit included (:func:`config_launch`).

CPU tensors take :func:`fused_chain_matvec_plain`, which runs the per-axis
plain version axis by axis: the same sum in the same order as the kernel,
rounded to the operand type at the same points.

The ``'cumsum'`` epilogue (an inclusive prefix sum along marked axes after
the chain, ResidualPlanner+'s implicit prefix matrix) runs inside the fused
kernel.  Where the JAX package applies it with ``jnp.cumsum`` outside Pallas
(the per-axis fallback, a chain with no live factor) the port applies
:func:`apply_epilogue`, ``torch.cumsum``.
"""
from __future__ import annotations

import ctypes
import math
import time
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import REGISTRY, TRACER
from repro_torch.obs.naming import chain_label

from .._build import load
from ._layout import device_factor, normalize_factor
from .kron_matvec import kron_axis_matvec_plain
from .ops import per_axis_chain
from .stats import CHAIN_STATS

_SMEM_BUDGET = 232448   # 227 KB of shared memory per Hopper block
_TARGET_ELEMS = 4096    # aim for this many elements per buffer per block
_MAX_AXES = 16          # fused_chain.cu's kMaxAxes
_EXACT_CAP = 16         # fused_chain.cu's kExactCap: registers for exactly n

# Operand types of the kernel's three instantiations: (torch dtype, bytes,
# the launcher's dtype code).
_OPERANDS = {"float32": (torch.float32, 4, 0),
             "bfloat16": (torch.bfloat16, 2, 1),
             "float16": (torch.float16, 2, 2)}
_NARROW_COUNTER = {"bfloat16": "bf16_launches", "float16": "fp16_launches"}

# Host dispatch time of one chain call, labeled like the roofline gauges
# (obs/naming.py).  CUDA launches are asynchronous and nothing here waits for
# the card, so this is the wrapper's host time (planning, packing, queuing),
# not the kernel's device time, as in the JAX package.
_LAUNCH_SECONDS = REGISTRY.histogram(
    "repro_kernel_launch_seconds",
    "Host dispatch time of one kron-chain call (launch queued, not "
    "device time)",
    labels=("chain",),
    buckets=(1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0))


@lru_cache(maxsize=4096)
def _launch_series(in_dims: Tuple[int, ...], batch: int, compute_dtype: str):
    """(chain label, its ``repro_kernel_launch_seconds`` child), resolved
    once per chain shape."""
    label = chain_label(in_dims, batch, compute_dtype)
    return label, _LAUNCH_SECONDS.labels(chain=label)


def dtype_name(dtype) -> str:
    """'float32', 'bfloat16' or 'float16' for a name or torch dtype; raises
    on anything else."""
    name = str(dtype).replace("torch.", "")
    if name not in _OPERANDS:
        raise ValueError(f"unsupported compute dtype {dtype!r}; expected one "
                         f"of {sorted(_OPERANDS)}")
    return name


@dataclass(frozen=True)
class ChainPlan:
    """Static launch plan for one fused chain."""

    in_dims: Tuple[int, ...]                        # per-axis input sizes n_i
    fshapes: Tuple[Optional[Tuple[int, int]], ...]  # (m_i, n_i) or None (identity)
    out_dims: Tuple[int, ...]                       # per-axis output sizes
    n_in: int                                       # prod(in_dims)
    n_out: int                                      # prod(out_dims)
    buf: int           # elements of one ping-pong buffer: the widest intermediate
    nf: int            # elements of all factors, rows padded to pad4(n_i)
    rows: int          # batch rows per block
    smem_bytes: int    # factors + 2 * rows * buf elements, at the operand size
    fused_ok: bool     # fits the shared-memory budget?
    epilogue: Tuple[Optional[str], ...] = ()        # per-axis 'cumsum' or None
    compute_dtype: str = "float32"                  # operand type (fp32 sums)

    @property
    def signature(self) -> tuple:
        return (self.in_dims, self.fshapes, self.epilogue, self.compute_dtype)


def pad4(n: int) -> int:
    """``n`` rounded up to a multiple of 4: the packed row length of a factor
    with n columns (the kernel reads a factor row four values at a time)."""
    return -(-int(n) // 4) * 4


def axis_cap(n: int) -> int:
    """How the kernel contracts an axis of n inputs: n (up to 16), a line's
    inputs in a register array of that length, one thread a line; 0 (above
    16), streamed, one thread per 4 outputs of a line."""
    return int(n) if n <= _EXACT_CAP else 0


@dataclass(frozen=True)
class FusedAxis:
    """One axis of a fused launch, as ``fused_chain.cu``'s ``Axis`` takes it.

    Before the axis the block's ``rows`` rows hold the tensor
    (rows * pre, n, post) contiguously; a line (o, t), o < rows * pre,
    t < post, reads x[o, :, t] and writes y[o, :, t] (m outputs).  With
    ``cap == n`` a thread owns a line; with ``cap == 0`` a thread owns an
    item, 4 consecutive outputs of a line (:meth:`items`).  The epilogue
    scans the lines (o, t), t < epost, of the output tensor
    (rows * pre, m, epost).
    """

    n: int
    m: int
    off: int     # offset of the packed factor (rows of pad4(n)); -1: identity
    epi: int     # 1: 'cumsum' along the axis after the chain
    pre: int     # prod of the output sizes before the axis
    post: int    # prod of the input sizes after it
    epost: int   # prod of the output sizes after it
    cap: int     # axis_cap(n): n (registers) or 0 (streamed); 0 if identity

    def lines(self, rows: int) -> int:
        """Lines of the contraction for ``rows`` rows."""
        return rows * self.pre * self.post

    def items(self, rows: int) -> int:
        """Threads' work items for ``rows`` rows: a line each with cap n,
        4 outputs of a line each when streamed."""
        lines = self.lines(rows)
        return lines if self.cap else lines * -(-self.m // 4)


@lru_cache(maxsize=4096)
def fused_geometry(plan: "ChainPlan") -> Tuple[FusedAxis, ...]:
    """Per-axis launch geometry of ``plan``: the records the launcher passes
    to the kernel (``fused_chain.cu``'s ``Axis``, 8 ints each)."""
    out, off = [], 0
    k = len(plan.in_dims)
    for a, (spec, n, m) in enumerate(zip(plan.fshapes, plan.in_dims,
                                         plan.out_dims)):
        live = spec is not None
        out.append(FusedAxis(
            n, m, off if live else -1,
            int(plan.epilogue[a] == "cumsum"),
            math.prod(plan.out_dims[:a]), math.prod(plan.in_dims[a + 1:k]),
            math.prod(plan.out_dims[a + 1:k]), axis_cap(n) if live else 0))
        off += m * pad4(n) if live else 0
    return tuple(out)


def fit_rows(nf: int, buf: int, compute_dtype: str, budget: int) -> int:
    """Rows per block whose factors and two buffers fit ``budget`` bytes."""
    isz = _OPERANDS[compute_dtype][1]
    return (int(budget) - isz * nf) // (2 * isz * buf)


def factor_shapes(factors: Sequence, dims: Sequence[int]
                  ) -> Tuple[Optional[Tuple[int, int]], ...]:
    """(m_i, n_i) of each factor after :func:`normalize_factor`, None for an
    identity axis; raises when a factor does not match its axis."""
    return _shapes([normalize_factor(f, int(n)) for f, n in zip(factors, dims)],
                   dims)


def _shapes(s_facs: Sequence[Optional[np.ndarray]], dims: Sequence[int]
            ) -> Tuple[Optional[Tuple[int, int]], ...]:
    """:func:`factor_shapes` of factors already normalized."""
    out = []
    for s, n in zip(s_facs, dims):
        if s is not None and s.shape[1] != n:
            raise ValueError(f"factor {s.shape} does not match axis size {n}")
        out.append(None if s is None else (int(s.shape[0]), int(n)))
    return tuple(out)


def plan_shapes(fshapes: Sequence[Optional[Tuple[int, int]]],
                dims: Sequence[int], batch: int = 1,
                smem_budget: Optional[int] = None,
                epilogue: Optional[Sequence[Optional[str]]] = None,
                rows: Optional[int] = None,
                compute_dtype: str = "float32") -> ChainPlan:
    """:func:`plan_chain` from the factors' shapes alone (memoised: plans
    are immutable, and a serving path plans the same chains every call)."""
    dims = tuple(int(d) for d in dims)
    fshapes = tuple(None if s is None else (int(s[0]), int(s[1]))
                    for s in fshapes)
    return _plan(fshapes, dims, int(batch),
                 _SMEM_BUDGET if smem_budget is None else int(smem_budget),
                 tuple(epilogue) if epilogue is not None else (None,) * len(dims),
                 None if rows is None else int(rows), dtype_name(compute_dtype))


@lru_cache(maxsize=4096)
def _plan(fshapes, dims, batch, budget, epilogue, rows, compute_dtype
          ) -> ChainPlan:
    if len(epilogue) != len(dims):
        raise ValueError(f"epilogue length {len(epilogue)} != {len(dims)} axes")
    if any(op not in (None, "cumsum") for op in epilogue):
        raise ValueError(f"unknown epilogue op in {epilogue}")
    out_dims = tuple(n if s is None else s[0] for s, n in zip(fshapes, dims))
    sizes = [math.prod(dims)]
    cur = list(dims)
    for axis, spec in enumerate(fshapes):
        if spec is not None:
            cur[axis] = spec[0]
            sizes.append(math.prod(cur))
    buf = max(sizes)
    nf = sum(m * pad4(n) for s in fshapes if s is not None for m, n in [s])
    if rows is None:
        fit = fit_rows(nf, buf, compute_dtype, budget)
        rows = max(1, min(fit, max(int(batch), 1),
                          max(1, _TARGET_ELEMS // buf)))
    smem = _OPERANDS[compute_dtype][1] * (nf + 2 * rows * buf)
    fused_ok = rows >= 1 and smem <= budget and len(dims) <= _MAX_AXES
    return ChainPlan(dims, fshapes, out_dims, math.prod(dims),
                     math.prod(out_dims), buf, nf, rows, smem, fused_ok,
                     epilogue, compute_dtype)


def fused_cache_info():
    """``cache_info()`` of the launch-plan cache: one entry for each chain
    shape, batch, budget, epilogue, row count and operand type planned."""
    return _plan.cache_info()


def plan_chain(factors: Sequence, dims: Sequence[int], batch: int = 1,
               smem_budget: Optional[int] = None,
               epilogue: Optional[Sequence[Optional[str]]] = None,
               rows: Optional[int] = None,
               compute_dtype: str = "float32") -> ChainPlan:
    """Plan the fused launch of ``(⊗_i factors[i])`` on a (batch, N) stack.

    ``rows`` (default) starts from about ``_TARGET_ELEMS`` elements of work
    per buffer and shrinks until the factors and both buffers fit
    ``smem_budget`` (default: the 227 KB a Hopper block may use); an explicit
    ``rows`` is planned as given, and ``fused_ok`` says whether it fits.
    Factors and buffers count at the operand size of ``compute_dtype``
    (4 bytes for float32, 2 for bfloat16 and float16), each factor with its
    rows padded to a multiple of 4 columns, as the kernel stages it.
    ``epilogue[i]`` is ``'cumsum'`` or None per axis; the kernel scans in
    place, so it changes neither ``rows`` nor ``fused_ok``.
    """
    return plan_shapes(factor_shapes(factors, dims), dims, batch, smem_budget,
                       epilogue, rows, compute_dtype)


def config_launch(fshapes, dims: Sequence[int], batch: int,
                  epilogue: Optional[Sequence[Optional[str]]], cfg,
                  allow_narrow: bool) -> Tuple[ChainPlan, bool]:
    """(plan, fused) of a call served under the tuned config ``cfg`` (None:
    untuned).

    A narrow ``cfg`` reaching a call with ``allow_narrow=False`` is
    re-planned whole at float32: the default rows and the fit against the
    227 KB budget, since a narrow plan's rows at four bytes an element can
    overflow shared memory.  The JAX package keeps the narrow block size
    there (its own test ``test_narrow_clamped_without_allow_narrow`` fails
    on that); the port does not.
    """
    if cfg is None:
        plan = plan_shapes(fshapes, dims, batch, epilogue=epilogue)
        return plan, plan.fused_ok
    if allow_narrow or cfg.compute_dtype == "float32":
        plan = plan_shapes(fshapes, dims, batch, cfg.smem_budget, epilogue,
                           cfg.rows, cfg.compute_dtype)
    else:
        plan = plan_shapes(fshapes, dims, batch, epilogue=epilogue)
    return plan, cfg.fused and plan.fused_ok


def _lib():
    lib = load("fused_chain")
    fn = lib.fused_chain_launch
    if fn.argtypes is None:
        ip = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ip, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def apply_epilogue(y: torch.Tensor, out_dims: Sequence[int],
                   epilogue: Optional[Sequence[Optional[str]]]) -> torch.Tensor:
    """``torch.cumsum`` along the marked axes of a (B, Π out_dims) stack.

    The epilogue of the routes that do not run it in the fused kernel: the
    per-axis fallback, a chain with no live factor, and the plain version.
    A narrow ``y`` is summed in float32 and rounded back after each axis, as
    the kernel does.
    """
    if not epilogue or all(op is None for op in epilogue):
        return y
    b = y.shape[0]
    t = y.reshape((b,) + tuple(out_dims))
    acc = torch.float32 if y.dtype in (torch.bfloat16, torch.float16) \
        else y.dtype
    for axis, op in enumerate(epilogue):
        if op == "cumsum":
            t = torch.cumsum(t, dim=axis + 1, dtype=acc).to(y.dtype)
    return t.reshape(b, -1)


def _narrow_axis(dtype: torch.dtype):
    """The per-axis plain version with narrow operands: both rounded to
    ``dtype``, summed in float32, the result rounded to ``dtype``."""
    def apply(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return kron_axis_matvec_plain(s.to(dtype).float(), x.float()).to(dtype)
    return apply


def fused_chain_matvec_plain(s_facs: Sequence, x: torch.Tensor,
                             dims: Sequence[int],
                             epilogue: Optional[Sequence[Optional[str]]] = None,
                             compute_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version: the per-axis plain version on each live axis,
    then :func:`apply_epilogue`; float32 out.

    With a narrow ``compute_dtype`` the input and the factors are rounded to
    it, each axis sums in float32 and rounds its result to it, the epilogue
    rounds after each axis, and the end is widened to float32: the rounding
    points of the kernel (and of the JAX package's ``_contract``).
    """
    dt = _OPERANDS[dtype_name(compute_dtype)][0]
    apply = kron_axis_matvec_plain if dt == torch.float32 else _narrow_axis(dt)
    b = x.shape[0]
    y = per_axis_chain(s_facs, x.to(dt).reshape(-1), dims, b,
                       apply).reshape(b, -1)
    out_dims = [n if s is None else s.shape[0]
                for s, n in zip(map(normalize_factor, s_facs, dims), dims)]
    return apply_epilogue(y, out_dims, epilogue).float()


def pack_factors(plan: ChainPlan, s_facs: Sequence[Optional[np.ndarray]]
                 ) -> np.ndarray:
    """The live factors in one float32 array of ``plan.nf`` elements, each
    (m, n) factor at its geometry offset with rows padded to pad4(n) by
    zeros."""
    f = np.zeros(plan.nf, dtype=np.float32)
    for ax, s in zip(fused_geometry(plan), s_facs):
        if s is not None:
            ld = pad4(ax.n)
            f[ax.off:ax.off + ax.m * ld].reshape(ax.m, ld)[:, :ax.n] = s
    return f


@lru_cache(maxsize=4096)
def _geometry_arg(plan: ChainPlan):
    """The launcher's geometry argument: the records of
    :func:`fused_geometry` as one C int array (built once per plan; the
    launcher only reads it)."""
    flat = [v for ax in fused_geometry(plan)
            for v in (ax.n, ax.m, ax.off, ax.epi, ax.pre, ax.post, ax.epost,
                      ax.cap)]
    return (ctypes.c_int * len(flat))(*flat)


def _launch(plan: ChainPlan, s_facs: Sequence[Optional[np.ndarray]],
            x: torch.Tensor) -> torch.Tensor:
    b = x.shape[0]
    dt, _, code = _OPERANDS[plan.compute_dtype]
    # Packed on the host, rounded to the operand type and copied once.
    f = device_factor(pack_factors(plan, s_facs), dt, x.device)
    y = torch.empty((b, plan.n_out), dtype=torch.float32, device=x.device)
    if b == 0:
        return y
    with torch.cuda.device(x.device):
        rc = _lib()(x.data_ptr(), y.data_ptr(), f.data_ptr(), b,
                    len(plan.in_dims), _geometry_arg(plan), plan.nf,
                    plan.rows, plan.buf, -(-b // plan.rows), plan.smem_bytes,
                    code, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_chain kernel launch failed: CUDA error {rc}")
    CHAIN_STATS.inc("fused_launches")
    if any(op == "cumsum" for op in plan.epilogue):
        CHAIN_STATS.inc("epilogue_launches")
    if code:
        CHAIN_STATS.inc("narrow_launches")
        CHAIN_STATS.inc(_NARROW_COUNTER[plan.compute_dtype])
    return y


def _fallback_per_axis(s_facs: Sequence[Optional[np.ndarray]],
                       x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """Per-axis kernel on the batched stack: identity on the batch axis."""
    b = x.shape[0]
    return per_axis_chain(s_facs, x.reshape(-1), dims, b).reshape(b, -1)


def fused_chain_matvec(factors: Sequence, x: torch.Tensor, dims: Sequence[int],
                       smem_budget: Optional[int] = None,
                       epilogue: Optional[Sequence[Optional[str]]] = None,
                       rows: Optional[int] = None,
                       compute_dtype: Optional[str] = None,
                       allow_narrow: bool = False) -> torch.Tensor:
    """Apply ``⊗_i factors[i]`` to a stack ``x`` of shape (B, N) (or flat (N,)).

    One launch of the fused kernel per chain on CUDA tensors; chains over the
    shared-memory budget (or tuned to it) go to the per-axis kernel, which
    is float32 only.  CPU tensors take the plain version.
    ``epilogue[i] == 'cumsum'`` adds an inclusive prefix sum along output
    axis i after the chain: in the fused kernel, or with
    :func:`apply_epilogue` on the fallback and when no factor is live.

    Launch config: any of ``rows`` / ``smem_budget`` / ``compute_dtype``
    passed explicitly is used as given (the rest untuned) and bypasses the
    autotuner; otherwise the tuned config of the chain is resolved
    (``REPRO_KERNEL_AUTOTUNE``; ``off`` keeps the untuned plan), and a
    tuned narrow dtype serves only when ``allow_narrow``.
    Returns float32 of shape (B, n_out), or (n_out,) for a flat input.
    """
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
    fshapes = _shapes(s_facs, dims)
    if rows is not None or smem_budget is not None or compute_dtype is not None:
        plan = plan_shapes(fshapes, dims, b, smem_budget, epilogue, rows,
                           "float32" if compute_dtype is None else compute_dtype)
        fused = plan.fused_ok
    else:
        from repro_torch.kernels.autotune.tuner import resolve_shapes
        cfg = resolve_shapes(fshapes, dims, b, epilogue, x.device)
        plan, fused = config_launch(fshapes, dims, b, epilogue, cfg,
                                    allow_narrow)
    if x.shape[1] != plan.n_in:
        raise ValueError(f"x width {x.shape[1]} != prod(dims) {plan.n_in}")
    n_epi = sum(op is not None for op in plan.epilogue)
    if all(s is None for s in s_facs):
        if not n_epi:
            return x[0] if flat_in else x
        y = apply_epilogue(x, plan.out_dims, plan.epilogue)
        CHAIN_STATS.inc("epilogue_axes", n_epi)
        return y[0] if flat_in else y
    t0 = time.monotonic()
    label, seconds = _launch_series(plan.in_dims, b, plan.compute_dtype)
    sp = TRACER.span("kernel.chain")
    if sp:
        sp.set(chain=label, fused=fused, rows=plan.rows,
               compute_dtype=plan.compute_dtype, smem_bytes=plan.smem_bytes)
    with sp:
        if not fused:
            CHAIN_STATS.inc("fallback_chains")
            y = _fallback_per_axis(s_facs, x, plan.in_dims)
            y = apply_epilogue(y, plan.out_dims, plan.epilogue)
        else:
            CHAIN_STATS.inc("fused_chains")
            if x.device.type == "cpu":
                y = fused_chain_matvec_plain(s_facs, x, plan.in_dims,
                                             plan.epilogue, plan.compute_dtype)
            else:
                y = _launch(plan, s_facs, x.contiguous())
    CHAIN_STATS.inc("epilogue_axes", n_epi)
    seconds.observe(time.monotonic() - t0)
    return y[0] if flat_in else y
