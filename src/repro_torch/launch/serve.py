"""Release-server app layer: stand up the multi-tenant serving tier.

The port of ``repro.launch.serve``.  Wires a
:class:`~repro_torch.serve.server.ReleaseServer` (async queue + worker loop,
cross-tenant signature batching), a durable
:class:`~repro_torch.serve.ledger.BudgetLedger` (JSONL journal,
crash-recovery replay), and the stdlib ``/stats`` / ``/ledger`` /
``/metrics`` / ``/healthz`` HTTP endpoints into one runnable process, on the
card unless ``--device cpu``.

Run (demo traffic, then keep serving /stats until interrupted)::

    PYTHONPATH=src python -m repro_torch.launch.serve --tenants 4 \\
        --requests 8 --ledger ledger.jsonl --port 8787

``--once`` exits after the demo traffic instead of serving forever.
``--device cpu`` runs the plain PyTorch versions of the kernels on the CPU.
``--trace PATH`` turns on request tracing and appends the span tree of every
served request to PATH as JSONL.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Sequence, Union

from repro_torch.core import all_kway, select
from repro_torch.data.tabular import (adult_domain, marginals_from_records,
                                      synthetic_records)
from repro_torch.obs import TRACER
from repro_torch.serve import (BudgetLedger, ReleaseRequest, ReleaseServer,
                               start_stats_http)


def build_server(ledger_path: str, n_tenants: int = 4,
                 rho: Union[float, Sequence[float]] = 4.0,
                 max_batch: int = 16, max_wait_ms: float = 2.0,
                 kway: int = 2, device=None) -> ReleaseServer:
    """A started server with ``n_tenants`` tenants sharing one workload
    *shape* (Adult, all ≤``kway``-way marginals), on ``device`` (CUDA
    unless ``"cpu"``).

    Every tenant gets its own plan object, its own synthetic records, and its
    own ρ budget (``rho``: one value for all, or one per tenant) — but the
    per-axis signatures coincide, so concurrent requests fuse into shared
    chain calls.
    """
    rhos = [float(rho)] * n_tenants if isinstance(rho, (int, float)) \
        else [float(r) for r in rho]
    if len(rhos) != n_tenants:
        raise ValueError(f"{len(rhos)} budgets for {n_tenants} tenants")
    dom = adult_domain()
    ledger = BudgetLedger(ledger_path)
    server = ReleaseServer(ledger, max_batch=max_batch,
                           max_wait_ms=max_wait_ms, device=device)
    server.start()
    for t in range(n_tenants):
        wk = all_kway(dom, kway, include_lower=True)
        plan = select(wk, pcost_budget=1.0)
        server.register_tenant(f"tenant-{t}", plan, rho=rhos[t])
    return server


def demo_traffic(server: ReleaseServer, requests_per_tenant: int = 4,
                 n_records: int = 60_000) -> dict:
    """Submit release traffic from every tenant; returns summary metrics."""
    dom = adult_domain()
    futures = []
    t0 = time.monotonic()
    for i, tenant in enumerate(server.tenants()):
        plan = server._sessions[tenant].plan
        records = synthetic_records(dom, n_records, seed=i)
        margs = marginals_from_records(dom, plan.cliques, records)
        for _r in range(requests_per_tenant):
            futures.append(server.submit(
                ReleaseRequest(tenant=tenant, marginals=margs)))
    results = [f.result(timeout=300) for f in futures]
    wall = time.monotonic() - t0
    return {"requests": len(results), "wall_s": wall,
            "requests_per_s": len(results) / max(wall, 1e-9),
            "batched_fraction": sum(r.batched for r in results) / len(results)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ledger",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ledger.jsonl"),
                    help="JSONL journal path (replayed if it exists)")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--rho", type=float, default=4.0,
                    help="per-tenant zCDP budget")
    ap.add_argument("--requests", type=int, default=4,
                    help="demo requests per tenant")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--port", type=int, default=0,
                    help="stats HTTP port (0 = ephemeral)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--once", action="store_true",
                    help="exit after the demo traffic (no serve-forever)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append request span trees to PATH as JSONL")
    args = ap.parse_args()

    if args.trace:
        TRACER.enable(args.trace)
    server = build_server(args.ledger, args.tenants, rho=args.rho,
                          max_batch=args.max_batch, device=args.device)
    httpd, port = start_stats_http(server, port=args.port)
    print(f"[serve] {args.tenants} tenants registered on {server.device}; "
          f"ledger={args.ledger} (replayed "
          f"{server.ledger.replayed_records} records); "
          f"stats on http://127.0.0.1:{port}/stats, "
          f"metrics on /metrics"
          + (f"; tracing to {args.trace}" if args.trace else ""))
    summary = demo_traffic(server, args.requests)
    print(f"[serve] demo traffic: {json.dumps(summary)}")
    print("[serve] ledger:", json.dumps(server.ledger.report(), default=str))
    if args.once:
        httpd.shutdown()
        server.stop()
        server.ledger.close()
        if args.trace:
            TRACER.flush()
        return
    print("[serve] serving /stats until interrupted (ctrl-C)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        httpd.shutdown()
        server.stop()
        server.ledger.close()


if __name__ == "__main__":
    main()
