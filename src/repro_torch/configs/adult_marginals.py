"""Paper-plane config: the Adult ≤3-way marginal workload (paper §8).

Usage:
    from repro_torch.configs.adult_marginals import make
    domain, workload = make(kmax=3)
"""
from repro_torch.core import Domain, all_kway
from repro_torch.data.tabular import ADULT_SIZES


def make(kmax: int = 3, weights: str = "cells"):
    domain = Domain.create(ADULT_SIZES, names=[f"adult{i}" for i in range(14)])
    wk = all_kway(domain, kmax, include_lower=True).reweighted(weights)
    return domain, wk
