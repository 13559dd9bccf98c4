"""served_closed_loop: ``clients_per_tenant`` clients for each of
``tenants`` tenants send release requests through ``ReleaseServer.submit``,
each client waiting for its result before it sends the next (a closed
loop).

Every tenant has the configuration's plan and its own marginals (its own
data, drawn from the run's seed) and a budget of ``rho`` in a
``BudgetLedger`` whose journal fsyncs each charge when ``fsync`` is true.
The server drains up to ``max_batch`` requests, waiting ``max_wait_ms`` for
a batch to fill.  Each request carries its noise seed, so its measurement
equals ``measure(plan, marginals, gen)`` for a generator seeded alike.
Set-up starts the server, registers and warms every tenant
(``engine_build_s``) and serves one request per tenant.
"""
from __future__ import annotations

import threading
import time

from rpbench.harness.spec import Done

#: seconds a client waits for one result before it counts it as failed
RESULT_TIMEOUT_S = 300.0


def _tenant(i: int) -> str:
    return f"tenant{i}"


def setup(ctx):
    from repro_torch.serve import BudgetLedger, ReleaseRequest, ReleaseServer
    tr = ctx.traffic
    path = ctx.workdir / "ledger.jsonl"
    path.unlink(missing_ok=True)
    ledger = BudgetLedger(str(path), fsync=bool(tr["fsync"]))
    server = ReleaseServer(ledger, max_batch=int(tr["max_batch"]),
                           max_wait_ms=float(tr["max_wait_ms"]),
                           device=ctx.device).start()
    t = time.monotonic()
    for i in range(int(tr["tenants"])):
        server.register_tenant(_tenant(i), ctx.plan, rho=float(tr["rho"]),
                               warm=True)
    ctx.setup["engine_build_s"] = time.monotonic() - t
    t = time.monotonic()
    futs = [server.submit(ReleaseRequest(_tenant(i), marginals=m,
                                         seed=ctx.seeds()))
            for i, m in enumerate(ctx.marginals)]
    for f in futs:
        f.result(RESULT_TIMEOUT_S)
    ctx.setup["warm_release_s"] = time.monotonic() - t
    return server, ledger, path


def run(ctx, state) -> None:
    from repro_torch.serve import ReleaseRequest
    server = state[0]
    end = time.monotonic() + ctx.seconds

    def client(tenant: int) -> None:
        margs = ctx.marginals[tenant]
        while time.monotonic() < end:
            seed = ctx.seeds()
            t0 = time.monotonic()
            try:
                res = server.submit(ReleaseRequest(
                    _tenant(tenant), marginals=margs, seed=seed)
                ).result(RESULT_TIMEOUT_S)
            except Exception as exc:   # counted as failed, the client goes on
                ctx.done(Done(tenant, seed, t0, time.monotonic(), repr(exc)),
                         None, None)
                continue
            ctx.done(Done(tenant, seed, t0, time.monotonic()), res.tables,
                     res.measurements)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(int(ctx.traffic["tenants"]))
               for _ in range(int(ctx.traffic["clients_per_tenant"]))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(ctx.seconds + RESULT_TIMEOUT_S)
    if any(th.is_alive() for th in threads):
        raise RuntimeError("a client of the served loop did not finish")


def close(state) -> None:
    server, ledger, path = state
    server.stop()
    ledger.close()
    path.unlink(missing_ok=True)
