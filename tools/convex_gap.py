"""How far the JAX package's ``select_convex`` stops from the max-variance
optimum on Adult, all <=3-way marginals.

``select_convex(loss="max_variance")`` runs Adam on an annealed logsumexp
smoothing; ``select_max_variance`` solves the same problem exactly.  The
ratio of their losses is what the convex route gives away at a step size.
The PyTorch port's ratios are printed by ``chip_smoke.py`` (``[select-
convex]``); this script reads the reference's, on the CPU.

Usage::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/convex_gap.py [--lr 0.05 0.01]
"""
from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[0.05, 0.01])
    ap.add_argument("--steps", type=int, default=3000)
    args = ap.parse_args()

    from repro.core import all_kway, select_convex, select_max_variance
    from repro.data.tabular import adult_domain

    wk = all_kway(adult_domain(), 3, include_lower=True)
    opt = select_max_variance(wk, 1.0, backend="numpy").loss_value
    print(f"Adult <=3-way max-variance optimum {opt:.9g}")
    for lr in args.lr:
        plan = select_convex(wk, 1.0, loss="max_variance", steps=args.steps,
                             lr=lr)
        print(f"select_convex steps {args.steps} lr {lr}: loss "
              f"{plan.loss_value:.9g}, loss / optimum "
              f"{plan.loss_value / opt:.6f}")


if __name__ == "__main__":
    main()
