r"""Segment sums whose order of addition is fixed by the data.

``torch.Tensor.index_add_`` (and the backward of an index gather) adds on
CUDA with atomics, in whatever order the threads arrive, so two calls on
the same inputs can differ in their last bits.  :class:`Segments` computes
the same many-to-one sum, ``out[t] = Σ_{i: seg[i] = t} x[i]``, from gathers
and ``sum(dim=1)`` alone, whose order of addition depends only on the
shapes:

* the entries are sorted by target once (a stable sort, so ties keep their
  input order);
* a target with c entries is padded to the next power of two W ≥ c, and the
  targets of one width form one bucket, a (targets, W) gather index whose
  pad slots point at a zero appended to ``x`` (small maps pad every target
  to the widest W: one bucket);
* a sum is one gather and one ``sum(dim=1)`` per bucket, written to its
  targets by ``index_copy_`` (every target in one bucket only).

A padded bucket holds fewer than twice its entries, so a sum moves at most
about twice the bytes of an ``index_add_``, in a few launches per distinct
width.  :meth:`Segments.sum` and :meth:`Segments.gather` are each other's
adjoints, and each one's backward is the other: gradients through either
are as reproducible as their forward passes.  The structure is built with
torch ops on the device of ``seg``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# Pad every target to the widest count when that costs at most four times
# the entries plus this many slots: one gather and one sum then replace a
# few launches per width (the planner's tables are this small).
_ONE_BUCKET = 1 << 18


class Segments:
    """A fixed map of ``N`` entries onto ``n`` targets, ``seg[i]`` ∈ [0, n).

    ``sum(x)`` reduces (N, ...) to (n, ...) (empty targets get 0);
    ``gather(y)`` expands (n, ...) to (N, ...) as ``y[seg]``.
    """

    def __init__(self, seg: torch.Tensor, n: int):
        seg = torch.as_tensor(seg).reshape(-1).to(torch.int64)
        self.seg = seg
        self.n = int(n)
        self.n_entries = int(seg.numel())
        dev = seg.device
        self.buckets: List[Tuple[int, torch.Tensor, torch.Tensor]] = []
        if self.n_entries == 0:
            return
        if int(seg.min()) < 0 or int(seg.max()) >= self.n:
            raise ValueError(f"segment ids must lie in [0, {self.n})")
        order = torch.sort(seg, stable=True).indices
        counts = torch.bincount(seg, minlength=self.n)
        starts = torch.cumsum(counts, 0) - counts
        width = torch.ones_like(counts)
        while bool((width < counts).any()):
            width = torch.where(width < counts, 2 * width, width)
        widest = int(width.max())
        if self.n * widest <= 4 * self.n_entries + _ONE_BUCKET:
            width = torch.full_like(counts, widest)   # one launch pays more
        else:
            width = torch.where(counts > 0, width, 0)
        for w in sorted(int(v) for v in torch.unique(width) if int(v) > 0):
            targets = torch.nonzero(width == w).reshape(-1)
            lane = torch.arange(w, device=dev)
            pos = starts[targets, None] + lane
            live = lane < counts[targets, None]
            gidx = torch.where(live, order[pos.clamp_max(self.n_entries - 1)],
                               self.n_entries)
            self.buckets.append((w, targets, gidx))

    def __repr__(self) -> str:
        return (f"Segments(entries={self.n_entries}, targets={self.n}, "
                f"widths={[w for w, _, _ in self.buckets]})")

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._sum_padded(torch.cat([x, x.new_zeros((1,) + x.shape[1:])]))

    def _sum_padded(self, xe: torch.Tensor) -> torch.Tensor:
        """The sum of ``xe[:-1]``; ``xe[-1]`` is the zero the pads read."""
        if xe.shape[0] != self.n_entries + 1:
            raise ValueError(f"x has {xe.shape[0] - 1} entries, want "
                             f"{self.n_entries}")
        out = xe.new_zeros((self.n,) + tuple(xe.shape[1:]))
        for w, targets, gidx in self.buckets:
            part = xe[gidx[:, 0]] if w == 1 else xe[gidx].sum(dim=1)
            out.index_copy_(0, targets, part)
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``out[t] = Σ_{i: seg[i] = t} x[i]`` for a (N, ...) tensor."""
        return _SegmentSum.apply(x, self)

    def sum_cat(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """:meth:`sum` of the concatenation of flat ``parts`` (no grad),
        concatenated with the pads' zero in one copy."""
        flat = [p.reshape(-1) for p in parts]
        return self._sum_padded(torch.cat(flat + [flat[0].new_zeros(1)]))

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """``y[seg]``; its gradient is :meth:`sum` of the incoming one."""
        return _SegmentGather.apply(y, self)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, segs):
        ctx.segs = segs
        return segs._sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.segs.seg], None


class _SegmentGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, segs):
        ctx.segs = segs
        return y[segs.seg]

    @staticmethod
    def backward(ctx, grad):
        return ctx.segs._sum(grad), None
