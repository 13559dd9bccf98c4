"""Noisy marginals of training-corpus document attributes and DP-SGD from
one privacy budget, on the PyTorch port: the counterpart of
``examples/dp_corpus_stats.py``.

The release runs ResidualPlanner's measure and reconstruct on the card (the
fused Kronecker-chain kernel); the remaining budget then pays for DP-SGD
steps until it refuses one.  Runs on CUDA unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/dp_corpus_stats_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import BudgetExhausted, Domain, MarginalWorkload, PrivacyBudget
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.engine.corpus_stats import corpus_marginal_release
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.train.dp import DPSGDAccountant, DPSGDConfig


def main(argv=None):
    """Returns (noisy tables, the number of DP-SGD steps the budget funds,
    the accountant's report)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    budget = PrivacyBudget.from_zcdp(rho=2.0)   # total pcost 4.0
    dom = Domain.create([8, 8], names=["source", "len_bucket"])
    wk = MarginalWorkload(dom, ((0,), (1,), (0, 1)))

    gen = synthetic_lm_batches(1000, batch=512, seq_len=8, seed=0)
    recs = np.concatenate([next(gen)["doc_attrs"] for _ in range(4)], axis=0)

    tables, variances, report = corpus_marginal_release(
        dom, wk, recs, budget, 1.0, torch.Generator(dev).manual_seed(0),
        device=dev)
    print("noisy source×length marginal (first row):",
          np.round(tables[(0, 1)].reshape(8, 8)[0], 1))
    print("per-marginal variances:", {k: round(v, 3) for k, v in variances.items()})
    print("after release:", report)

    acct = DPSGDAccountant(DPSGDConfig(noise_multiplier=1.0), budget)
    steps = 0
    try:                     # charge until the budget refuses
        while True:
            acct.charge_step()
            steps += 1
    except BudgetExhausted as refusal:
        print(f"budget refused step {steps + 1}: {refusal}")
    print(f"remaining budget funds {steps} DP-SGD steps at sigma=1.0")
    print("final:", acct.report())
    return tables, steps, acct.report()


if __name__ == "__main__":
    main()
