"""Reduce a profiler trace and the program's spans to what the per-layer
readers and the breakdown need.

Everything is on the host's monotonic clock, in seconds: the profiler
stamps its events on its own clock, so :class:`Trace` shifts them by the
offset that one marker read on both clocks gives.  On the card the marker
is a kernel (``torch.cuda._sleep``'s ``spin_kernel``) launched on an idle
device right after the monotonic clock is read, so the session needs no
host activity; without a card it is a host annotation.
"""
from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]
MARK = "rpbench.mark"
MARK_KERNEL = "spin_kernel"


def merged(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], as disjoint sorted
    intervals."""
    out: List[Interval] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_seconds(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    return sum(b - a for a, b in merged(intervals, lo, hi))


def idle_gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > t:
            out.append((t, a))
        t = b
    if hi > t:
        out.append((t, hi))
    return out


def label_at(t: float, spans: Sequence[Tuple[str, float, float]],
             default: str = "between releases") -> str:
    """The name of the innermost (shortest) span open at ``t``."""
    best: Optional[Tuple[float, str]] = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return default if best is None else best[1]


def op_name(name: str) -> str:
    """The breakdown's name of a device operation: copies by direction."""
    if name.startswith("Memcpy HtoD"):
        return "H2D"
    if name.startswith("Memcpy DtoH"):
        return "D2H"
    if name.startswith("Memcpy DtoD"):
        return "D2D"
    return name[:120]


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class Trace:
    """Device operations of one profiler session, on the monotonic clock:
    ``ops`` are (name, start, end)."""

    def __init__(self, ops: List[Tuple[str, float, float]]):
        self.ops = ops

    @classmethod
    def from_profiler(cls, prof, mark_mono_ns: int) -> "Trace":
        """The device operations of a finished ``torch.profiler`` session:
        the first marker (the ``MARK_KERNEL`` kernel or the ``MARK``
        annotation), started right after ``mark_mono_ns`` on the monotonic
        clock, gives the offset of the profiler's clock."""
        evs = prof.profiler.kineto_results.events()
        mark = sorted(e.start_ns() for e in evs
                      if e.name() == MARK or MARK_KERNEL in e.name())
        if not mark:
            raise RuntimeError("the profiler recorded no marker")
        offset = mark[0] - mark_mono_ns
        ops = []
        for e in evs:
            if "CUDA" not in str(e.device_type()):
                continue
            a = (e.start_ns() - offset) * 1e-9
            ops.append((e.name(), a, a + e.duration_ns() * 1e-9))
        return cls(ops)

    def window(self, lo: float, hi: float) -> "Trace":
        return Trace([o for o in self.ops if o[2] > lo and o[1] < hi])

    def kernel_seconds(self) -> float:
        return sum(b - a for n, a, b in self.ops if is_kernel(n))

    def busy(self, lo: float, hi: float) -> float:
        return busy_seconds(((a, b) for _, a, b in self.ops), lo, hi)

    def top_ops(self, n: int = 10) -> List[list]:
        by: dict = {}
        for name, a, b in self.ops:
            k = op_name(name)
            by[k] = by.get(k, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, lo: float, hi: float, spans, n: int = 10) -> List[list]:
        gaps = sorted(idle_gaps(((a, b) for _, a, b in self.ops), lo, hi),
                      key=lambda g: g[0] - g[1])[:n]
        return [[label_at((a + b) / 2, spans), b - a] for a, b in gaps]


def mark(device) -> int:
    """Put the marker into the running profiler session; returns the
    monotonic ns read just before it started."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t = time.monotonic_ns()
        torch.cuda._sleep(1)
        torch.cuda.synchronize(device)
        return t
    from torch.profiler import record_function
    t = time.monotonic_ns()
    with record_function(MARK):
        pass
    return t
