"""Analytic cost model of the port's two chain kernels, for the autotuner.

The JAX package's cost model (``repro/roofline/cost_model.py``) scores a
Pallas launch on a TPU: padded (8, 128) tiles and grid steps that run one
after another, each paying a step overhead.  Neither holds on Hopper, so
this module re-derives the two costs for the CUDA kernels of this package:

* :meth:`CostModel.chain_cost` — one launch of ``csrc/fused_chain.cu`` under a
  :class:`~repro_torch.kernels.kron_matvec.fused.ChainPlan` (rows per block,
  operand dtype).  Bytes: every row read once as float32 and written once as
  float32 (the kernel narrows and widens on chip, so a narrow dtype moves no
  fewer bytes), plus the factors that every block stages into shared memory.
  Operations: 2·m·n per output of every live axis and one add per output of
  every ``'cumsum'`` axis (the kernel scans; it does not multiply by
  ``tril``).
* :meth:`CostModel.per_axis_cost` — the per-axis route: one launch of
  ``csrc/kron_axis.cu`` per live axis (each a full round trip through device
  memory) at the tile and grid of ``axis_geometry``, then one
  ``torch.cumsum`` per marked axis.

:meth:`CostModel.roofline_terms` scores a whole LM step of the dry run
(:mod:`repro_torch.roofline.analyze`) with the rows' datasheet tensor-core
and NVLink rates, which the tuner never reads.

Both kernel costs take the roofline time, ``max(operations / peak, bytes /
bandwidth)``, scale it by what the launch shape costs
(:meth:`CostModel.occupancy_slowdown`) and add one launch overhead per
launch.  CUDA blocks run at once across the SMs, so there is no per-block
overhead; what a launch shape costs is low occupancy: fewer blocks than SMs
leave SMs idle, and few warps on an SM (the blocks an SM holds are limited
by its shared memory, its registers and its threads) leave its latency
unhidden.  The per-axis kernel's threads carry 32 independent sums each, so
fewer warps hide its latency.  A launch with more, smaller blocks is never
scored slower for that alone: only the factor bytes each extra block stages
cost it anything.

The ``"cpu"`` row scores the plain PyTorch versions that serve CPU tensors:
a fixed cost per torch operation plus the bytes they touch.  The fused and
per-axis routes run the same operations there, so they score the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.kron_matvec.fused import fused_geometry, pad4
from repro_torch.kernels.kron_matvec.kron_matvec import axis_geometry

_THREADS = 256               # threads a block of the fused kernel (kThreads)
_SATURATING_WARPS = 32       # warps an SM needs in flight to reach its rates
# ... for the per-axis kernel, whose threads each run 32 independent FMA
# chains (an 8 x 4 micro-tile): 2 warps a scheduler keep its FMA pipes busy,
# where the fused kernel's threads run 1 to 4 chains.
_AXIS_SATURATING_WARPS = 8
_BLOCK_SMEM_RESERVED = 1024  # shared memory the runtime keeps for each block
# Registers a thread of each kernel uses at most over its instantiations:
# `nvcc -Xptxas -v` for sm_90a (chip_smoke.py prints it in its [build]
# phase).
_FUSED_REGS = 48
_AXIS_REGS = 109


@dataclass(frozen=True)
class DeviceSpec:
    """What the cost model needs to know of one device.

    ``peak_flops`` is the rate with narrow (bf16/fp16) operands that the
    port's kernels can reach, not the card's tensor-core peak: the fused
    kernel converts each operand to float and accumulates with fp32
    ``fmaf``, so on an H100 that is the fp32 rate.  ``smem_limit`` is the
    shared memory one block may use (the JAX package's VMEM limit and
    untuned budget both become it).  ``sms == 0`` marks a device that runs
    the plain versions.
    """

    kind: str
    peak_flops: float            # FLOP/s with narrow operands (see above)
    peak_flops_f32: float        # FLOP/s with float32 operands
    hbm_bw: float                # device memory bytes/s
    smem_limit: int              # shared memory bytes one block may use
    launch_s: float              # one kernel launch (CPU: one torch op)
    sms: int = 0                 # streaming multiprocessors; 0: plain versions
    smem_per_sm: int = 0         # shared memory bytes of one SM
    threads_per_sm: int = 2048   # resident threads an SM may hold
    regs_per_sm: int = 65536     # 32-bit registers of one SM
    # The LM roofline's rates (roofline/analyze.py), read by nothing the
    # tuner scores: dense bf16 on the tensor cores, and the card-to-card
    # link (the counterpart of a TPU's ICI).  0 for a row without them.
    tensor_flops_bf16: float = 0.0
    link_bw: float = 0.0

    @property
    def plain(self) -> bool:
        return self.sms == 0

    def peak_for(self, compute_dtype: str) -> float:
        return self.peak_flops_f32 if compute_dtype == "float32" \
            else self.peak_flops


_BLOCK_SMEM = 232448   # 227 KB: what one Hopper block may use

# H100 rows: NVIDIA H100 Tensor Core GPU datasheet (fp32 outside the tensor
# cores, HBM bandwidth); SM counts from the NVIDIA H100 architecture white
# paper (132 SXM5, 114 PCIe); 228 KB of shared memory per SM, 227 KB a block.
# The same datasheet gives the BF16 tensor-core rate with 2:4 sparsity
# (1,979 TFLOPS SXM, 1,513 PCIe), of which the dense rate is half, and the
# NVLink rate of a card (900 GB/s SXM, 600 GB/s for PCIe's NVLink bridge).
_H100_SXM = DeviceSpec("nvidia h100 80gb hbm3", peak_flops=67e12,
                       peak_flops_f32=67e12, hbm_bw=3.35e12,
                       smem_limit=_BLOCK_SMEM, launch_s=4e-6, sms=132,
                       smem_per_sm=233472, tensor_flops_bf16=989.5e12,
                       link_bw=900e9)
DEVICE_TABLE: Dict[str, DeviceSpec] = {
    "cpu": DeviceSpec("cpu", peak_flops=1e11, peak_flops_f32=1e11,
                      hbm_bw=5e10, smem_limit=_BLOCK_SMEM, launch_s=1e-5),
    _H100_SXM.kind: _H100_SXM,
    "nvidia h100 pcie": replace(_H100_SXM, kind="nvidia h100 pcie",
                                peak_flops=51e12, peak_flops_f32=51e12,
                                hbm_bw=2.0e12, sms=114,
                                tensor_flops_bf16=756.5e12, link_bw=600e9),
}


def device_spec(kind: str) -> DeviceSpec:
    """The :class:`DeviceSpec` of a device name (``torch.cuda.get_device_name``).

    H100 names map to the SXM or PCIe row; any other CUDA card is scored with
    the SXM row's rates under its own name, so its tuning cache is its own.
    """
    k = kind.strip().lower()
    if k in DEVICE_TABLE:
        return DEVICE_TABLE[k]
    if "h100" in k:
        return DEVICE_TABLE["nvidia h100 pcie" if "pcie" in k else _H100_SXM.kind]
    return replace(_H100_SXM, kind=k)


_DETECTED: Dict[int, DeviceSpec] = {}


def detect_device(device=None) -> DeviceSpec:
    """The spec of the device a call runs on: the CPU row for a CPU device,
    else the row of the CUDA card's name (cached per card).  ``None`` means
    CUDA when there is a card, the CPU otherwise."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return DEVICE_TABLE["cpu"]
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    spec = _DETECTED.get(idx)
    if spec is None:
        spec = _DETECTED[idx] = device_spec(torch.cuda.get_device_name(idx))
    return spec


@dataclass(frozen=True)
class ChainCost:
    """Predicted cost of one fused launch under a plan."""

    flops: float
    hbm_bytes: float
    intensity: float             # flops / hbm_bytes
    blocks: int
    smem_bytes: int
    fits: bool                   # smem_bytes <= the device's block limit
    slowdown: float              # occupancy factor on the roofline time
    t_compute: float
    t_memory: float
    t_overhead: float
    predicted_s: float           # max(compute, memory) * slowdown + overhead


def _itemsize(dtype_name: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}[str(dtype_name)]


def chain_flops(in_dims: Sequence[int],
                fshapes: Sequence[Optional[Tuple[int, int]]],
                epilogue: Sequence[Optional[str]] = ()) -> int:
    """Operations for ONE row: 2·m·n per output of each live axis, then one
    add per output of each ``'cumsum'`` axis."""
    cur = list(in_dims)
    flops = 0
    for axis, spec in enumerate(fshapes):
        if spec is None:
            continue
        m, n = spec
        flops += 2 * m * n * (math.prod(cur) // cur[axis])
        cur[axis] = m
    return flops + math.prod(cur) * sum(op is not None for op in epilogue or ())


def fused_fmas(plan) -> int:
    """FMAs the fused kernel issues for ONE row of ``plan``: n for each
    output of a register axis; on a streamed axis pad4(n) for each of the 4
    outputs of every item (fused_chain.cu's contract_streamed)."""
    return sum(ax.items(1) * (ax.m * ax.n if ax.cap else 4 * pad4(ax.n))
               for ax in fused_geometry(plan) if ax.off >= 0)


def chain_bytes(in_dims: Sequence[int],
                fshapes: Sequence[Optional[Tuple[int, int]]], batch: int,
                factor_itemsize: int = 4) -> int:
    """Bytes one launch must move: each float32 row read once and written
    once, each factor read once."""
    out = [n if s is None else s[0] for s, n in zip(fshapes, in_dims)]
    nf = sum(m * n for s in fshapes if s is not None for m, n in [s])
    return 4 * batch * (math.prod(in_dims) + math.prod(out)) \
        + factor_itemsize * nf


class CostModel:
    """Scores fused and per-axis launches of one chain on one device."""

    def __init__(self, device: Optional[DeviceSpec] = None):
        self.device = detect_device() if device is None else device

    # ------------------------------------------------------------- occupancy
    def blocks_per_sm(self, smem_bytes: int, regs: int = 0,
                      threads: int = _THREADS) -> int:
        """Blocks of ``threads`` threads one SM holds at this shared memory
        and ``regs`` registers a thread (0: registers not counted); 0 when
        the block does not fit."""
        dev = self.device
        if smem_bytes > dev.smem_limit:
            return 0
        bps = min(dev.threads_per_sm // threads,
                  dev.smem_per_sm // (smem_bytes + _BLOCK_SMEM_RESERVED))
        if regs:
            bps = min(bps, dev.regs_per_sm // (regs * threads))
        return bps

    def occupancy_slowdown(self, blocks: int, smem_bytes: int,
                           regs: int = 0, threads: int = _THREADS,
                           saturating: int = _SATURATING_WARPS) -> float:
        """Time of the launch over its time at the full rate of every SM.

        The busiest SM gets ceil(blocks / SMs) blocks and runs them in
        rounds of at most ``blocks_per_sm``; a round of k blocks runs at
        min(1, w k / saturating) of the SM's rate (w warps a block;
        ``saturating`` warps hide latency, 32 unless the kernel's threads
        carry more independent work).  The ideal is blocks / SMs block-times
        at the full rate.
        """
        dev = self.device
        bps = self.blocks_per_sm(smem_bytes, regs, threads)
        if bps < 1:
            return math.inf
        blocks = max(int(blocks), 1)
        per_sm = -(-blocks // dev.sms)
        warps = threads // 32
        full, rest = divmod(per_sm, bps)
        t = full * bps / min(1.0, warps * bps / saturating)
        if rest:
            t += rest / min(1.0, warps * rest / saturating)
        return t / (blocks / dev.sms)

    # ------------------------------------------------------------ plain (CPU)
    def _plain_cost(self, in_dims, fshapes, epilogue, batch: int,
                    compute_dtype: str) -> float:
        """The plain versions: per live axis, one multiply and one add per
        term over the whole stack (kron_axis_matvec_plain), two casts when
        narrow; one cumsum per marked axis."""
        dev = self.device
        narrow = compute_dtype != "float32"
        cur = list(in_dims)
        ops, nbytes = 0, 0.0
        for axis, spec in enumerate(fshapes):
            if spec is None:
                continue
            m, n = spec
            out = batch * math.prod(cur) // cur[axis] * m
            ops += 2 * n + (3 if narrow else 0)
            nbytes += 12.0 * out * 2 * n
            cur[axis] = m
        n_out = batch * math.prod(cur)
        for op in epilogue or ():
            if op is not None:
                ops += 2 if narrow else 1
                nbytes += 8.0 * n_out
        flops = batch * chain_flops(in_dims, fshapes, epilogue)
        return ops * dev.launch_s + max(flops / dev.peak_for(compute_dtype),
                                        nbytes / dev.hbm_bw)

    # ------------------------------------------------------------ fused chain
    def chain_cost(self, plan, batch: int) -> ChainCost:
        """Cost of one fused launch of ``plan`` on a (batch, n_in) stack.

        The compute time counts the FMAs the kernel issues
        (:func:`fused_fmas`: a streamed axis multiplies its zero padding up
        to pad4(n) and to 4 outputs an item); ``flops`` stays the chain's
        own.  Occupancy counts the kernel's registers as well as its shared
        memory.
        """
        dev = self.device
        b = max(int(batch), 1)
        blocks = -(-b // plan.rows)
        flops = float(b * chain_flops(plan.in_dims, plan.fshapes, plan.epilogue))
        isz = _itemsize(plan.compute_dtype)
        # Every block stages every factor (from L2 mostly; counted at the
        # device memory rate, an upper bound).
        hbm = float(chain_bytes(plan.in_dims, plan.fshapes, b, isz)
                    + (blocks - 1) * isz * plan.nf)
        fits = plan.smem_bytes <= dev.smem_limit
        if dev.plain:
            t = self._plain_cost(plan.in_dims, plan.fshapes, plan.epilogue, b,
                                 plan.compute_dtype)
            return ChainCost(flops, hbm, flops / hbm, blocks, plan.smem_bytes,
                             fits, 1.0, t, t, 0.0, t)
        issued = flops + 2.0 * b * (fused_fmas(plan) - chain_flops(
            plan.in_dims, plan.fshapes) // 2)
        t_c = issued / dev.peak_for(plan.compute_dtype)
        t_m = hbm / dev.hbm_bw
        slow = self.occupancy_slowdown(blocks, plan.smem_bytes, _FUSED_REGS)
        return ChainCost(flops, hbm, flops / hbm, blocks, plan.smem_bytes,
                         fits, slow, t_c, t_m, dev.launch_s,
                         max(t_c, t_m) * slow + dev.launch_s)

    # --------------------------------------------------------------- per axis
    def per_axis_cost(self, in_dims: Sequence[int],
                      fshapes: Sequence[Optional[Tuple[int, int]]],
                      batch: int,
                      epilogue: Sequence[Optional[str]] = ()) -> float:
        """Seconds of the per-axis route: one kron_axis.cu launch per live
        axis, its input and output through device memory each time, then one
        torch.cumsum per marked axis.

        A launch is scored at its geometry (``axis_geometry``): the FMAs of
        whole warp tiles (q rounded up to a warp's 32, k to the 8-value
        chunk, columns to the tile), x read once per q tile and S once per
        column tile, and the occupancy of its 2-D grid of 128-thread blocks.
        """
        dev = self.device
        b = max(int(batch), 1)
        if dev.plain:
            return self._plain_cost(in_dims, fshapes, epilogue, b, "float32")
        cur = list(in_dims)
        total = 0.0
        for axis, spec in enumerate(fshapes):
            if spec is None:
                continue
            m, n = spec
            L = b * math.prod(cur[:axis])
            R = math.prod(cur[axis + 1:])
            g = axis_geometry(L, n, R, m)
            flops = (2.0 * g.grid_c * g.bn * -(-m // 32) * 32
                     * -(-n // g.bk) * g.bk)
            nbytes = 4.0 * (g.grid_q * L * n * R + L * m * R
                            + g.grid_c * m * n)
            t = max(flops / dev.peak_flops_f32, nbytes / dev.hbm_bw)
            total += t * self.occupancy_slowdown(
                g.blocks, g.smem_bytes, _AXIS_REGS, g.threads,
                _AXIS_SATURATING_WARPS) \
                + dev.launch_s
            cur[axis] = m
        n_out = b * math.prod(cur)
        for op in epilogue or ():
            if op is not None:
                total += 8.0 * n_out / dev.hbm_bw + dev.launch_s
        return total

    # -------------------------------------------------------- roofline terms
    def roofline_terms(self, flops: float, hbm_bytes: float,
                       coll_bytes: float = 0.0, chips: int = 1) -> dict:
        """The three classic terms for a global (all-chip) workload: FLOPs
        at the dense bf16 tensor-core rate, bytes at the memory rate,
        collective bytes at the card-to-card link rate (each falls back to
        the row's kernel rates where it has none)."""
        dev = self.device
        t_compute = flops / (chips * (dev.tensor_flops_bf16 or dev.peak_flops))
        t_memory = hbm_bytes / (chips * dev.hbm_bw)
        t_collective = coll_bytes / (chips * (dev.link_bw or dev.hbm_bw))
        terms = {"compute": t_compute, "memory": t_memory,
                 "collective": t_collective}
        bottleneck = max(terms, key=terms.get)
        return {"t_compute": t_compute, "t_memory": t_memory,
                "t_collective": t_collective, "bottleneck": bottleneck,
                "t_dominant": terms[bottleneck]}
