"""Section 6.2 on the PyTorch port: how the weighted-SoV objective treats
individual marginals under equi / cell-size / sqrt weighting (paper
Figs 1-3).

The closed-form SoV plan (Lemma 2) is computed on the host in float64, so
this example needs no device.

Run:  PYTHONPATH=src python examples/cell_fairness_torch.py
"""
from __future__ import annotations

from repro_torch.core import all_kway, select_sum_of_variances
from repro_torch.data.tabular import adult_domain

SCHEMES = ("equi", "cells", "sqrt_cells")


def fairness(scheme: str, max_k: int = 3):
    """{"ranges": {k: (min variance, max variance, marginals)}, "spread":
    max / min variance over all marginals} of the Adult <=``max_k``-way
    workload weighted by ``scheme``."""
    dom = adult_domain()
    wks = all_kway(dom, max_k, include_lower=True).reweighted(scheme)
    plan = select_sum_of_variances(wks, 1.0, dict(wks.weights))
    by_k = {}
    for c, v in plan.workload_variances().items():
        by_k.setdefault(len(c), []).append(v)
    allv = [v for vs in by_k.values() for v in vs]
    return {"ranges": {k: (min(vs), max(vs), len(vs))
                       for k, vs in sorted(by_k.items())},
            "spread": max(allv) / min(allv)}


def main():
    out = {}
    for scheme in SCHEMES:
        out[scheme] = r = fairness(scheme)
        print(f"\n== weighting: {scheme} ==")
        for k, (lo, hi, n) in r["ranges"].items():
            print(f"  {k}-way: var range [{lo:.4g}, {hi:.4g}] ({n} marginals)")
        print(f"  spread across marginals: {r['spread']:.1f}x "
              f"(paper: equi is the most even)")
    return out


if __name__ == "__main__":
    main()
