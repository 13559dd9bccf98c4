"""Launch and routing counters for the kron kernels.

Bumped by the host-side wrappers: ``fused_launches`` and ``axis_launches``
each time a CUDA kernel is launched (and only then — the plain PyTorch
versions that serve CPU tensors count nothing), with ``epilogue_launches``
counting the fused launches that ran a ``'cumsum'`` epilogue in the kernel
and ``narrow_launches`` those with bfloat16 or float16 operands (split by
type in ``bf16_launches`` / ``fp16_launches``); ``fused_chains`` /
``fallback_chains`` each time ``fused_chain_matvec`` routes a chain to the
fused kernel or to the per-axis fallback, and ``epilogue_axes`` the epilogue
axes it applied, on any device.  A run resets them, drives its path and
reads them, to show which kernels served it.

The global :data:`CHAIN_STATS` counts in the monotone
``repro_kernel_events_total{event=...}`` family of the metrics registry,
which ``/metrics`` exposes (a Prometheus counter never goes backwards), and
the window that ``reset_chain_stats()`` / ``chain_stats()`` reset and read is
each count minus its value at the last reset, as the JAX package's
two-tier store reads; an increment is then one locked add, not two (the
wrappers bump a few events per call, on the host path of every launch).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.obs import REGISTRY, AtomicCounter

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

_KERNEL_EVENTS = REGISTRY.counter(
    "repro_kernel_events_total",
    "Kron-chain kernel events (launches, path choices, epilogue axes)",
    labels=("event",))
# The family's child per event, resolved once: a label lookup costs more
# than the increment.
_MIRRORED = {f: _KERNEL_EVENTS.labels(event=f) for f in _FIELDS}


class ChainStats:
    """Atomic kernel-event counters with a resettable window.

    ``mirror=True`` (the process-global :data:`CHAIN_STATS`) counts in the
    registry's monotone family; ad-hoc instances count in cells of their
    own.  Either way the window is the count minus ``_base``, its value at
    the last :meth:`reset`.
    """

    __slots__ = ("_cells", "_base")

    def __init__(self, mirror: bool = False):
        self._cells = dict(_MIRRORED) if mirror else \
            {f: AtomicCounter() for f in _FIELDS}
        self.reset()

    def inc(self, name: str, n: int = 1) -> None:
        if n:
            self._cells[name].inc(n)

    def reset(self) -> None:
        self._base = {f: self._cells[f].value for f in _FIELDS}

    def snapshot(self) -> Dict[str, int]:
        return {f: int(self._cells[f].value - self._base[f]) for f in _FIELDS}


def _chain_field(name: str) -> property:
    def _get(self) -> int:
        return int(self._cells[name].value - self._base[name])

    def _set(self, v: int) -> None:
        self._base[name] = self._cells[name].value - v

    return property(_get, _set)


for _f in _FIELDS:
    setattr(ChainStats, _f, _chain_field(_f))
del _f


CHAIN_STATS = ChainStats(mirror=True)


def reset_chain_stats() -> None:
    CHAIN_STATS.reset()


def chain_stats() -> dict:
    return CHAIN_STATS.snapshot()
