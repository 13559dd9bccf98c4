r"""The SVD lower bound of Li & Miklau [34] on total matrix-mechanism error.

For a workload matrix W, the minimum total variance of any (Gaussian) matrix
mechanism with pcost budget c is bounded below by  (Σ_i s_i(W))² / (c·d) —
the squared nuclear norm of W over (budget × number of columns d).  The per-
column (per-record) privacy cost of the optimal mechanism is uniform for
marginals (the symmetrization argument of Appendix B), which is why the
average-column bound is *tight* here.  The paper uses it as the sanity
check for ResidualPlanner's optimality (Table 4: they coincide for marginals).

For a marginal workload the bound is computable *without* materializing W:
the Gram matrix  G = Σ_A Q_Aᵀ Q_A  is simultaneously diagonalized by the
residual basis (Thm 1).  On the residual subspace R_B (dimension Π_{i∈B}(n_i-1))
its eigenvalue is

    λ_B = Σ_{A ⊇ B, A ∈ Wkload}  w_A · Π_{i ∉ A} n_i

so  ‖W‖_* = tr √G = Σ_B mult_B · √λ_B  with B ranging over closure(Wkload).
(w_A re-weights workloads; w_A = 1 reproduces the plain stacked workload.)

The port's copy of ``repro.baselines.svdb``: host Python, unchanged.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.core.domain import Clique, MarginalWorkload, subsets


def svd_bound_marginals(workload: MarginalWorkload, pcost_budget: float = 1.0,
                        weights: Optional[Mapping[Clique, float]] = None) -> float:
    """Scalable SVD lower bound on total variance for a marginal workload."""
    dom = workload.domain
    lam: Dict[Clique, float] = {}
    for wc in workload.cliques:
        w = float((weights or {}).get(wc, 1.0))
        outside = 1.0
        for i in range(dom.n_attrs):
            if i not in set(wc):
                outside *= dom.attributes[i].size
        for sub in subsets(wc):
            lam[sub] = lam.get(sub, 0.0) + w * outside
    nuc = 0.0
    for b, lb in lam.items():
        nuc += dom.residual_size(b) * math.sqrt(lb)
    return nuc ** 2 / (pcost_budget * dom.universe_size())


def svd_bound_dense(W: np.ndarray, pcost_budget: float = 1.0) -> float:
    """Dense SVD bound (tests / tiny workloads)."""
    W = np.asarray(W, dtype=np.float64)
    s = np.linalg.svd(W, compute_uv=False)
    return float(s.sum() ** 2) / (pcost_budget * W.shape[1])


def svdb_rmse_marginals(workload: MarginalWorkload, pcost_budget: float = 1.0) -> float:
    tv = svd_bound_marginals(workload, pcost_budget)
    return math.sqrt(tv / workload.total_cells())
