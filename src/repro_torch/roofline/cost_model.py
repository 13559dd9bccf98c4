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
  memory), then one ``torch.cumsum`` per marked axis.

Both take the roofline time, ``max(operations / peak, bytes / bandwidth)``,
scale it by what the launch shape costs (:meth:`CostModel.occupancy_slowdown`)
and add one launch overhead per launch.  CUDA blocks run at once across the
SMs, so there is no per-block overhead; what a launch shape costs is low
occupancy: fewer blocks than SMs leave SMs idle, and few warps on an SM (the
blocks an SM holds are limited by its shared memory and by 256 threads a
block) leave its latency unhidden.  A launch with more, smaller blocks is
never scored slower for that alone: only the factor bytes each extra block
stages cost it anything.

The ``"cpu"`` row scores the plain PyTorch versions that serve CPU tensors:
a fixed cost per torch operation plus the bytes they touch.  The fused and
per-axis routes run the same operations there, so they score the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import torch

_THREADS = 256               # threads a block, both kernels (kThreads)
_SATURATING_WARPS = 32       # warps an SM needs in flight to reach its rates
_BLOCK_SMEM_RESERVED = 1024  # shared memory the runtime keeps for each block


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
_H100_SXM = DeviceSpec("nvidia h100 80gb hbm3", peak_flops=67e12,
                       peak_flops_f32=67e12, hbm_bw=3.35e12,
                       smem_limit=_BLOCK_SMEM, launch_s=4e-6, sms=132,
                       smem_per_sm=233472)
DEVICE_TABLE: Dict[str, DeviceSpec] = {
    "cpu": DeviceSpec("cpu", peak_flops=1e11, peak_flops_f32=1e11,
                      hbm_bw=5e10, smem_limit=_BLOCK_SMEM, launch_s=1e-5),
    _H100_SXM.kind: _H100_SXM,
    "nvidia h100 pcie": replace(_H100_SXM, kind="nvidia h100 pcie",
                                peak_flops=51e12, peak_flops_f32=51e12,
                                hbm_bw=2.0e12, sms=114),
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
    def blocks_per_sm(self, smem_bytes: int) -> int:
        """Blocks of 256 threads one SM holds at this shared memory (0: none)."""
        dev = self.device
        if smem_bytes > dev.smem_limit:
            return 0
        return min(dev.threads_per_sm // _THREADS,
                   dev.smem_per_sm // (smem_bytes + _BLOCK_SMEM_RESERVED))

    def occupancy_slowdown(self, blocks: int, smem_bytes: int) -> float:
        """Time of the launch over its time at the full rate of every SM.

        The busiest SM gets ceil(blocks / SMs) blocks and runs them in
        rounds of at most ``blocks_per_sm``; a round of k blocks runs at
        min(1, 8k / 32) of the SM's rate (8 warps a block, 32 warps to hide
        latency).  The ideal is blocks / SMs block-times at the full rate.
        """
        dev = self.device
        bps = self.blocks_per_sm(smem_bytes)
        if bps < 1:
            return math.inf
        blocks = max(int(blocks), 1)
        per_sm = -(-blocks // dev.sms)
        warps = _THREADS // 32
        full, rest = divmod(per_sm, bps)
        t = full * bps / min(1.0, warps * bps / _SATURATING_WARPS)
        if rest:
            t += rest / min(1.0, warps * rest / _SATURATING_WARPS)
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
        """Cost of one fused launch of ``plan`` on a (batch, n_in) stack."""
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
        t_c = flops / dev.peak_for(plan.compute_dtype)
        t_m = hbm / dev.hbm_bw
        slow = self.occupancy_slowdown(blocks, plan.smem_bytes)
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
        torch.cumsum per marked axis.  ``inf`` if a factor does not fit a
        block."""
        from repro_torch.kernels.kron_matvec.kron_matvec import (
            _axis_smem_bytes, axis_tile)
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
            try:
                tile = axis_tile(n, m)
            except ValueError:
                return math.inf
            blocks = -(-(L * R) // tile)
            nbytes = 4.0 * (L * n * R + L * m * R + blocks * m * n)
            t = max(2.0 * L * m * n * R / dev.peak_flops_f32,
                    nbytes / dev.hbm_bw)
            total += t * self.occupancy_slowdown(
                blocks, _axis_smem_bytes(n, m, tile)) + dev.launch_s
            cur[axis] = m
        n_out = b * math.prod(cur)
        for op in epilogue or ():
            if op is not None:
                total += 8.0 * n_out / dev.hbm_bw + dev.launch_s
        return total
