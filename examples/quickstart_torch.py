"""Quickstart on the PyTorch port: the paper's pipeline on synthetic Adult
records.

select (optimal noise plan) -> measure (Algorithm 1) -> reconstruct
(Algorithm 2) through ``MarginalEngine.release`` -> 95% confidence
intervals from the closed-form variances (Theorem 4) and their coverage.

``--serve`` instead runs the multi-tenant release server: three tenants
with their own budgets, one fused batch of requests, a zero-charge
synthesis, and the durable budget ledger replayed from its journal.

Runs on CUDA unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--serve] [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import PrivacyBudget, all_kway, pcost_of_plan, select
from repro_torch.data.tabular import (adult_domain, marginals_from_records,
                                      synthetic_records)
from repro_torch.engine import MarginalEngine
from repro_torch.kernels.kron_matvec._layout import resolve_device


def main_release(device):
    dom = adult_domain()
    wk = all_kway(dom, 2, include_lower=True)          # all <=2-way marginals
    print(f"domain: {dom.n_attrs} attrs, universe {dom.universe_size():.2e}")
    print(f"workload: {len(wk.cliques)} marginals, {wk.total_cells()} cells")

    # 1) SELECT: optimal noise scales at total privacy cost 1 (0.5-zCDP)
    plan = select(wk, pcost_budget=1.0)
    print(f"selected {len(plan.cliques)} base mechanisms; "
          f"pcost={pcost_of_plan(plan):.6f} rmse={plan.rmse():.3f}")

    # 2) MEASURE and 3) RECONSTRUCT on synthetic records, on the device
    records = synthetic_records(dom, 100_000, seed=0)
    margs = marginals_from_records(dom, plan.cliques, records)
    engine = MarginalEngine(plan, device=device)
    tables, _ = engine.release(margs, torch.Generator(device).manual_seed(0))

    # 4) 95% confidence intervals from the closed-form variances
    shown = 0
    for c in wk.cliques:
        if len(c) != 2 or shown >= 3:
            continue
        sd = math.sqrt(plan.marginal_variance(c))
        true = margs[c]
        cover = np.mean(np.abs(tables[c] - true) <= 1.96 * sd)
        print(f"marginal {c}: cells={len(true)} sd={sd:.2f} "
              f"95%CI coverage={cover:.3f}")
        shown += 1
    budget = PrivacyBudget.from_zcdp(0.5)
    budget.charge(pcost_of_plan(plan))
    print("privacy report:", budget.report())


def main_serve(device):
    """Multi-tenant serving: server + ledger, 3 tenant requests."""
    from repro_torch.core import Domain
    from repro_torch.serve import BudgetLedger, ReleaseRequest, ReleaseServer

    dom = Domain.create([8, 8, 8, 8])
    wk = all_kway(dom, 2, include_lower=True)
    ledger_path = os.path.join(tempfile.mkdtemp(prefix="quickstart_serve_"),
                               "budgets.jsonl")
    ledger = BudgetLedger(ledger_path)
    tenants = ("acme", "globex", "initech")

    with ReleaseServer(ledger, max_batch=8, device=device) as server:
        plans = {}
        for name in tenants:
            plans[name] = select(wk, pcost_budget=1.0)
            server.register_tenant(name, plans[name], rho=0.5)
        print(f"registered {len(tenants)} tenants, ledger at {ledger_path}")

        server.pause()                       # let the batch fill, then fuse
        futures = []
        for i, name in enumerate(tenants):
            recs = synthetic_records(dom, 20_000, seed=i)
            margs = marginals_from_records(dom, plans[name].cliques, recs)
            futures.append(server.submit(ReleaseRequest(
                tenant=name, marginals=margs, postprocess="nonneg")))
        server.resume()
        for fut in futures:
            r = fut.result(timeout=300)
            print(f"  {r.tenant}: {len(r.tables)} tables, "
                  f"charged pcost={r.pcost_charged:.4f}, "
                  f"batched={r.batched} (batch of {r.batch_size}), "
                  f"{r.latency_s * 1e3:.0f} ms")

        synth = server.request_sync(ReleaseRequest(
            tenant="acme", kind="synthesis", n_records=1000, seed=7))
        print(f"  acme synthesis: {synth.records.shape[0]} records, "
              f"charged pcost={synth.pcost_charged} (postprocessing)")
        stats = server.stats_dict()
        print(f"server: {stats['requests_total']} requests, "
              f"batch occupancy {stats['batch_occupancy']:.1f}")
        for name, rep in server.ledger.report().items():
            print(f"  {name}: spent pcost {rep['pcost_spent']:.4f} of "
                  f"{rep['pcost_total']:.1f}, {rep['charges']} charges")
    ledger.close()
    replay = BudgetLedger(ledger_path)
    print(f"ledger replay: {replay.replayed_records} journal records, "
          f"spend survives restart: "
          f"{all(replay.spent(t) > 0 for t in tenants)}")
    replay.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--serve", action="store_true",
                    help="multi-tenant release server: 3 tenant requests, "
                         "durable ledger report")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return main_serve(device) if args.serve else main_release(device)


if __name__ == "__main__":
    main()
