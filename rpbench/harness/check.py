"""The comparison that decides ``correct``: the program's plan, residual
answers and workload tables against the plain reference
(``rpbench/reference/release_ref.py``), each as a gap beside its limit.

* ``sigma2_rel``: max over closure cliques of |σ²_program − σ²_ref| / σ²_ref.
* ``omega_rel``: max over the checked releases and closure cliques of
  max|ω_program − ω_ref| / max|ω_ref| (the clique's own cells).
* ``table_rel``: the same over the checked workload tables.

The reference replays each release's noise from its seed, so the gaps are
rounding, not noise.  A clique the program left out, or a value that is not
finite, reads as an infinite gap.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from rpbench.reference import release_ref as ref


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of max|got − want| / max|want| (float64)."""
    if got.shape != want.shape:
        return math.inf
    got, want = got.to(torch.float64), want.to(torch.float64)
    num = (got - want).abs().amax(dim=1)
    den = want.abs().amax(dim=1).clamp_min(1e-300)
    g = (num / den).max()
    return float(g) if torch.isfinite(g) else math.inf


class ReleaseCheck:
    """The reference of one configuration, and the gaps of the program's
    outputs from it.  ``dtype`` and ``plan_dtype`` are the reference's
    arithmetic types (lower ones make the control)."""

    def __init__(self, sizes: Sequence[int], workload: Sequence[tuple],
                 budget: float, device, dtype=torch.float64,
                 plan_dtype=np.float64):
        self.sizes = tuple(int(n) for n in sizes)
        self.workload = [tuple(c) for c in workload]
        self.device = torch.device(device)
        self.dtype = dtype
        self.closure, sig = ref.sov_sigma2(self.sizes, self.workload, budget,
                                           plan_dtype)
        self.sigma2 = dict(zip(self.closure, sig.astype(np.float64).tolist()))
        self.offsets = ref.noise_offsets(self.sizes, self.closure)

    def sigma2_gap(self, program_sigma2) -> float:
        """``program_sigma2(clique)`` is the program's σ² of one clique."""
        worst = 0.0
        for c, want in self.sigma2.items():
            try:
                got = float(program_sigma2(c))
            except KeyError:
                return math.inf
            gap = abs(got - want) / want
            if not math.isfinite(gap):
                return math.inf
            worst = max(worst, gap)
        return worst

    def reference(self, marginals, seed: int,
                  workload: Optional[Iterable[tuple]] = None):
        """(ω by group, tables by group) of one release of ``workload``
        (default: all of it)."""
        workload = self.workload if workload is None else list(workload)
        need = ref.closure(workload)
        z = ref.draw_noise(self.sizes, self.closure, seed, self.device)
        om = ref.measure(self.sizes, need, self.sigma2, marginals, z,
                         self.offsets, self.device, self.dtype)
        del z
        return om, ref.reconstruct(self.sizes, workload, om, self.device,
                                   self.dtype)

    def gaps(self, marginals, seed: int, omegas: Mapping[tuple, np.ndarray],
             tables: Mapping[tuple, np.ndarray],
             workload: Optional[Iterable[tuple]] = None):
        """(omega_rel, table_rel) of one release: ``omegas`` and ``tables``
        map each clique to the program's output."""
        om, tab = self.reference(marginals, seed, workload)
        return stacked_gap(om, omegas, self.device), \
            stacked_gap(tab, tables, self.device)


def stacked_gap(groups: Dict[tuple, tuple], got: Mapping[tuple, np.ndarray],
                device) -> float:
    worst = 0.0
    for _dims, (cliques, want) in groups.items():
        try:
            rows = np.stack([np.asarray(got[c], np.float64).reshape(-1)
                             for c in cliques])
        except (KeyError, ValueError):
            return math.inf
        worst = max(worst, row_gap(torch.from_numpy(rows).to(device), want))
    return worst
