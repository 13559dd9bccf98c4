"""Chain drivers over the per-axis kernel (kron_matvec.py).

``kron_matvec_kernel`` applies a full chain ⊗_i S_i with one per-axis launch
per non-trivial factor.  ``residual_measure_kernel`` computes the measurement
Hv + σHz with [v; z] stacked on the L (batch) axis, so both share every
launch.  The JAX package pads m and n to 8 and R to 512 around each launch to
fit the TPU's tiles; the CUDA kernel masks its own edges, so there is no pad
and no slice here.

This is the fallback path for chains too wide for the fused kernel
(fused.py) and the per-clique path of ``core.mechanism.residual_answer``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ._layout import device_factor, normalize_factor
from .kron_matvec import kron_axis_matvec


def per_axis_chain(factors: Sequence, x: torch.Tensor, dims: Sequence[int],
                   lead: int = 1, apply=kron_axis_matvec) -> torch.Tensor:
    """⊗_i factors[i] on ``lead`` stacked rows of the flat ``x``: one
    ``apply(S, x.view(L, n, R))`` per non-identity factor; returns flat."""
    cur = [int(d) for d in dims]
    for axis, f in enumerate(factors):
        s = normalize_factor(f, cur[axis])
        if s is None:
            continue
        L = lead * math.prod(cur[:axis])
        R = math.prod(cur[axis + 1:])
        s_t = torch.as_tensor(s, dtype=torch.float32) \
            if x.device.type == "cpu" else device_factor(s, torch.float32,
                                                          x.device)
        x = apply(s_t, x.reshape(L, cur[axis], R)).reshape(-1)
        cur[axis] = s.shape[0]
    return x


def kron_matvec_kernel(factors: Sequence, x: torch.Tensor,
                       dims: Sequence[int]) -> torch.Tensor:
    """(⊗_i factors[i]) x with the per-axis kernel; returns a flat tensor."""
    return per_axis_chain(factors, x.to(torch.float32).reshape(-1), dims)


def residual_measure_kernel(factors: Sequence, v: torch.Tensor,
                            z: torch.Tensor, sigma: float,
                            dims: Sequence[int]) -> torch.Tensor:
    """Measurement  H v + σ H z  (Algorithm 1 / 5) with [v; z] on the L axis."""
    x = torch.stack([v.to(torch.float32).reshape(-1),
                     z.to(torch.float32).reshape(-1)])
    out = per_axis_chain(factors, x.reshape(-1), dims, 2).reshape(2, -1)
    return out[0] + sigma * out[1]
