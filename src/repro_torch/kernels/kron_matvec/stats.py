"""Launch and routing counters for the kron kernels.

Plain integers, bumped by the host-side wrappers: ``fused_launches`` and
``axis_launches`` each time a CUDA kernel is launched (and only then — the
plain PyTorch versions that serve CPU tensors count nothing), with
``epilogue_launches`` counting the fused launches that ran a ``'cumsum'``
epilogue in the kernel and ``narrow_launches`` those with bfloat16 or
float16 operands (split by type in ``bf16_launches`` / ``fp16_launches``);
``fused_chains`` / ``fallback_chains`` each time
``fused_chain_matvec`` routes a chain to the fused kernel or to the per-axis
fallback, and ``epilogue_axes`` the epilogue axes it applied, on any device.  A run
resets them, drives its path and reads them, to show which kernels served it.
"""
from __future__ import annotations

from typing import Dict

_FIELDS = (
    "fused_launches",   # fused_chain.cu launches
    "axis_launches",    # kron_axis.cu launches
    "fused_chains",     # chains routed to the fused kernel
    "fallback_chains",  # chains routed to the per-axis kernel
    "epilogue_axes",    # 'cumsum' epilogue axes applied, on any route
    "epilogue_launches",  # fused_chain.cu launches that ran an epilogue
    "narrow_launches",  # fused_chain.cu launches with bf16 or fp16 operands
    "bf16_launches",    # ... of them with bfloat16 operands
    "fp16_launches",    # ... of them with float16 operands
)


class ChainStats:
    """Kernel-event counters with a resettable window."""

    __slots__ = _FIELDS

    def __init__(self):
        self.reset()

    def inc(self, name: str, n: int = 1) -> None:
        setattr(self, name, getattr(self, name) + n)

    def reset(self) -> None:
        for f in _FIELDS:
            setattr(self, f, 0)

    def snapshot(self) -> Dict[str, int]:
        return {f: getattr(self, f) for f in _FIELDS}


CHAIN_STATS = ChainStats()


def reset_chain_stats() -> None:
    CHAIN_STATS.reset()


def chain_stats() -> dict:
    return CHAIN_STATS.snapshot()
