"""The least time of a release's Kronecker chains: the benchmark's own,
frozen count of the work, and the table of peaks it is held against.

The counts follow the program's ``repro_torch.roofline.cost_model``
(``chain_flops``, ``chain_bytes``), copied here so that a later change to
the program cannot change the yardstick.  A chain applies ⊗ F_i, each F_i a
dense (m_i × n_i) float32 factor, to ``batch`` rows of Π n_i values:

* bytes: each input row read once and each output row written once, at 4
  bytes a value, and each factor read once;
* operations: 2·m·n for each output of each axis, the axes applied one at
  a time (the cost model's count), in the order that needs the fewest.

A release needs, for each signature group of g closure cliques of sizes
(n_1..n_k), one chain ⊗ Sub_{n_i} over g rows (ω = H (v + σ z): the noisy
marginal of each clique once), and for each signature group of g workload
cliques one chain ⊗ T_i (T_i = [Sub_{n_i}^† | 1/n_i], n_i × n_i) over g
rows of Π n_i slots (every subset's answer embedded once).  The count is
the same whatever kernel, route or library computes the chain.
"""
from __future__ import annotations

import itertools
import math
from collections import Counter
from typing import Iterable, List, Optional, Sequence, Tuple

#: Published peaks per card kind (NVIDIA's H100 SXM data sheet, dense):
#: device-memory bytes/s and float32 operations/s outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}

Chain = Tuple[Tuple[int, ...], Tuple[Tuple[int, int], ...], int]


def least_chain_flops(in_dims: Sequence[int],
                      fshapes: Sequence[Optional[Tuple[int, int]]]) -> int:
    """Operations for ONE row in the cheapest order of the axes."""
    k = len(in_dims)
    best = None
    for order in itertools.permutations(range(k)):
        cur = list(in_dims)
        flops = 0
        for axis in order:
            spec = fshapes[axis]
            if spec is None:
                continue
            m, n = spec
            flops += 2 * m * n * (math.prod(cur) // cur[axis])
            cur[axis] = m
        best = flops if best is None else min(best, flops)
    return best or 0


def chain_bytes(in_dims: Sequence[int],
                fshapes: Sequence[Optional[Tuple[int, int]]], batch: int,
                itemsize: int = 4) -> int:
    """Bytes one chain must move: each row read once and written once, each
    factor read once."""
    out = [n if s is None else s[0] for s, n in zip(fshapes, in_dims)]
    nf = sum(m * n for s in fshapes if s is not None for m, n in [s])
    return itemsize * (batch * (math.prod(in_dims) + math.prod(out)) + nf)


def least_seconds(chain: Chain, peaks: dict) -> float:
    """max(bytes / memory rate, operations / float32 rate) of one chain."""
    dims, fshapes, batch = chain
    t_mem = chain_bytes(dims, fshapes, batch) / peaks["hbm_bytes_per_s"]
    t_ops = batch * least_chain_flops(dims, fshapes) / peaks["fp32_flops_per_s"]
    return max(t_mem, t_ops)


def release_chains(sizes: Sequence[int], closure: Iterable[Tuple[int, ...]],
                   workload: Iterable[Tuple[int, ...]]) -> List[Chain]:
    """Every chain one release needs (module docstring), one per signature
    group of the closure and one per signature group of the workload."""
    out: List[Chain] = []
    for dims, g in Counter(tuple(sizes[i] for i in c)
                           for c in closure if c).items():
        out.append((dims, tuple((n - 1, n) for n in dims), g))
    for dims, g in Counter(tuple(sizes[i] for i in c)
                           for c in workload if c).items():
        out.append((dims, tuple((n, n) for n in dims), g))
    return out


def release_least_seconds(sizes, closure, workload, peaks: dict) -> float:
    return sum(least_seconds(c, peaks)
               for c in release_chains(sizes, closure, workload))
