"""The port's release server (repro_torch.serve) and measure_multi.

A counterpart of every test in tests/test_serve.py, on the port at the same
``Domain.create([5, 5, 5])`` setup with ``device="cpu"`` (the kernels' plain
versions), plus:

* ``measure_multi`` against per-request ``measure`` bit for bit on both
  routes, with and without pad lanes;
* the port's ``measure_multi`` ω against the JAX package's chain fed the
  port's noise (float32), and against a float64 numpy oracle (float64);
* served tables against the JAX package's ``reconstruct`` of the same
  measurements, and ``/metrics`` family names against the JAX server's;
* ``/stats`` scraped from 8 threads during traffic, server-assigned seeds,
  and ``python -m repro_torch.launch.serve --once --device cpu``.

The chain-call counter follows the reference's style: patch the chain entry
``measure_multi`` calls (``repro_torch.engine.multi.fused_chain_matvec`` on
the kernel route) and count invocations.
"""
import json
import math
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.core import Domain, all_kway, select
from repro_torch.core.accountant import BudgetExhausted
from repro_torch.core.mechanism import (draw_noise, measure, noise_offsets,
                                        pcost_of_plan)
from repro_torch.core.residual import sub_matrix
from repro_torch.data.tabular import marginals_from_records, synthetic_records
from repro_torch.engine import multi as multi_mod
from repro_torch.engine.multi import can_fuse, lane_bucket, measure_multi
from repro_torch.serve import (BudgetLedger, EnginePool, ReleaseRequest,
                               ReleaseServer, start_stats_http)
from repro_torch.serve.server import request_seed

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
DOM = Domain.create([5, 5, 5])          # uniform sizes -> 2 chain signatures
CPU = "cpu"


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _tenant_setup(n_tenants, n_records=2000, dom=DOM, k=2):
    wk = all_kway(dom, k, include_lower=True)
    plans, margs = [], []
    for t in range(n_tenants):
        plan = select(wk, pcost_budget=1.0)
        plans.append(plan)
        recs = synthetic_records(dom, n_records, seed=t)
        margs.append(marginals_from_records(dom, plan.cliques, recs))
    return plans, margs


def _server(tmp_path, plans, rho=100.0, **kw):
    ledger = BudgetLedger(os.path.join(str(tmp_path), "ledger.jsonl"),
                          fsync=False)
    srv = ReleaseServer(ledger, device=CPU, **kw).start()
    for i, plan in enumerate(plans):
        srv.register_tenant(f"t{i}", plan, rho=rho)
    return srv


def _paused_batch(srv, requests):
    srv.pause()
    futs = [srv.submit(r) for r in requests]
    srv.resume()
    return [f.result(120) for f in futs]


# ------------------------------------------------------------- measure_multi
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("sizes,n_items", [
    ([5, 5, 5], 1),        # g = 3 lanes a group: 5 pad lanes
    ([5, 5, 5], 3),        # g = 9: 7 pad lanes
    ([4, 4], 8),           # g = 16 and 8: no pad lane
])
def test_measure_multi_bit_exact_vs_per_request(use_kernel, sizes, n_items):
    plans, margs = _tenant_setup(n_items, dom=Domain.create(sizes))
    seq = [measure(p, m, _gen(i), use_kernel=use_kernel, device=CPU)
           for i, (p, m) in enumerate(zip(plans, margs))]
    fused = measure_multi([(p, m, _gen(i))
                           for i, (p, m) in enumerate(zip(plans, margs))],
                          use_kernel=use_kernel, device=CPU)
    for s, f in zip(seq, fused):
        assert set(s) == set(f)
        for c in s:
            assert np.array_equal(s[c].omega, f[c].omega), c
            assert s[c].sigma2 == f[c].sigma2


def test_lane_bucket_is_a_power_of_two_from_8():
    assert [lane_bucket(g) for g in (1, 3, 8, 9, 16, 17, 100)] == \
        [8, 8, 8, 16, 16, 32, 128]


def test_measure_multi_rejects_unfusable_plans():
    from repro_torch.core.plus import PlusSchema, select_plus
    dom = Domain.create([6, 4], kinds=["numeric", "categorical"])
    wk = all_kway(dom, 2, include_lower=True)
    schema = PlusSchema.create(dom, ["range", "identity"],
                               strategy_mode="hier", device=CPU)
    pp = select_plus(wk, schema, pcost_budget=1.0, device=CPU)
    assert not can_fuse(pp)
    recs = synthetic_records(dom, 500, seed=0)
    margs = marginals_from_records(dom, pp.cliques, recs)
    with pytest.raises(ValueError, match="plain marginal plans"):
        measure_multi([(pp, margs, _gen(0))], device=CPU)


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """measure_multi, EnginePool and ReleaseServer run on CUDA unless told
    otherwise; without a card they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    plans, margs = _tenant_setup(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_multi([(plans[0], margs[0], _gen(0))])
    with pytest.raises(RuntimeError, match="CUDA"):
        EnginePool().engine_for("a", plans[0])
    led = BudgetLedger(str(tmp_path / "l.jsonl"), fsync=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ReleaseServer(led)
    led.close()


def test_measure_multi_chain_matches_jax_chain_fed_the_same_noise():
    """ω of the port's measure_multi against the JAX package's chain
    (``kron_matvec_batched`` with ``sub_matrix``) fed the port's own noise:
    rel 2e-5 of max|ω| at float32 on both routes; at float64 the plain
    route within rel 1e-9 of a float64 numpy H v + σ H z."""
    import jax.numpy as jnp
    from repro.core.kron import kron_matvec_batched as j_chain
    from repro.core.residual import sub_matrix as j_sub
    plans, margs = _tenant_setup(3)
    for dtype, use_kernels in ((torch.float32, (True, False)),
                               (torch.float64, (False,))):
        for use_kernel in use_kernels:
            out = measure_multi([(p, m, _gen(20 + i)) for i, (p, m)
                                 in enumerate(zip(plans, margs))],
                                use_kernel=use_kernel, dtype=dtype,
                                device=CPU)
            for i, (plan, mg) in enumerate(zip(plans, margs)):
                z = draw_noise(plan, _gen(20 + i), CPU, dtype).numpy()
                offs = noise_offsets(plan)
                for c in plan.cliques:
                    dims = tuple(plan.domain.attributes[a].size for a in c)
                    m = plan.domain.n_cells(c)
                    v = np.asarray(mg[c]).reshape(-1)
                    zc = z[offs[c]:offs[c] + m]
                    s = math.sqrt(plan.sigmas[c])
                    got = out[i][c].omega
                    if not dims:
                        want = v + s * zc
                    elif dtype == torch.float32:
                        x = jnp.asarray(np.stack([v, zc]), jnp.float32)
                        y = np.asarray(j_chain([j_sub(n) for n in dims], x,
                                               dims), np.float64)
                        want = y[0] + s * y[1]
                    else:
                        x = np.stack([v, zc]).reshape((2,) + dims)
                        for ax, n in enumerate(dims):
                            x = np.moveaxis(np.tensordot(
                                sub_matrix(n), np.moveaxis(x, ax + 1, 0),
                                axes=([1], [0])), 0, ax + 1)
                        x = x.reshape(2, -1)
                        want = x[0] + s * x[1]
                    tol = 2e-5 if dtype == torch.float32 else 1e-9
                    scale = max(float(np.abs(want).max()), 1e-30)
                    assert float(np.abs(got - want).max()) <= tol * scale, \
                        (dtype, use_kernel, c)


# --------------------------------------------------------------- batching
def test_cross_tenant_batching_shares_chain_launches(tmp_path, monkeypatch):
    """Two same-signature tenants in one batch ride the SAME chain calls
    (chain-call counter): fused calls == calls for one tenant."""
    calls = {"n": 0}
    real = multi_mod.fused_chain_matvec

    def counting(factors, x, dims, **kw):
        calls["n"] += 1
        return real(factors, x, dims, **kw)

    monkeypatch.setattr(multi_mod, "fused_chain_matvec", counting)

    plans, margs = _tenant_setup(2)
    calls["n"] = 0
    measure_multi([(plans[0], margs[0], _gen(7))], device=CPU)
    solo_launches = calls["n"]
    assert solo_launches == 2            # signatures (5,) and (5,5)

    calls["n"] = 0
    measure_multi([(p, m, _gen(7 + i))
                   for i, (p, m) in enumerate(zip(plans, margs))], device=CPU)
    assert calls["n"] == solo_launches   # second tenant rides along free

    # ... and through the server: one paused batch, two tenants, no extra
    # calls beyond the solo count.
    srv = _server(tmp_path, plans, max_batch=8, max_wait_ms=1.0)
    try:
        srv.pause()
        futs = [srv.submit(ReleaseRequest(tenant=f"t{i}", marginals=margs[i],
                                          seed=i))
                for i in range(2)]
        calls["n"] = 0
        srv.resume()
        res = [f.result(120) for f in futs]
        assert calls["n"] == solo_launches
        assert all(r.batched for r in res)
        assert all(r.batch_size == 2 for r in res)
        assert srv.stats_dict()["batched_launch_groups"] == 3  # (), (5,), (5,5)
    finally:
        srv.stop()
        srv.ledger.close()


def test_server_sequential_and_batched_bit_identical(tmp_path):
    plans, margs = _tenant_setup(3)

    def run(max_batch):
        srv = _server(tmp_path.joinpath(f"b{max_batch}"), plans,
                      max_batch=max_batch)
        try:
            return _paused_batch(srv, [
                ReleaseRequest(tenant=f"t{i}", marginals=margs[i],
                               seed=40 + i) for i in range(3)])
        finally:
            srv.stop()
            srv.ledger.close()

    os.makedirs(str(tmp_path / "b1"), exist_ok=True)
    os.makedirs(str(tmp_path / "b8"), exist_ok=True)
    seq, bat = run(1), run(8)
    assert not any(r.batched for r in seq)
    assert all(r.batched for r in bat)
    for i, (a, b) in enumerate(zip(seq, bat)):
        assert set(a.tables) == set(b.tables)
        for c in a.tables:
            assert np.array_equal(a.tables[c], b.tables[c])
        # ... and the served measurement is measure() on the same seed
        direct = measure(plans[i], margs[i], _gen(40 + i), device=CPU)
        for c in direct:
            assert np.array_equal(b.measurements[c].omega, direct[c].omega)


def test_server_assigned_seeds_are_distinct_and_replayable(tmp_path):
    """seed=None: request i draws from request_seed(noise_seed, i) — the
    served measurement equals measure() on that seed, and two requests of
    one server never share noise."""
    seeds = [request_seed(3, i) for i in range(4096)]
    assert len(set(seeds)) == 4096
    assert len({s & 0xFFFFFFFF for s in seeds}) == 4096
    assert all(0 <= s < 1 << 64 for s in seeds)
    assert request_seed(3, 5) == seeds[5] != request_seed(4, 5)
    plans, margs = _tenant_setup(1)
    srv = _server(tmp_path, plans, noise_seed=3)
    try:
        r0 = srv.request_sync(ReleaseRequest(tenant="t0", marginals=margs[0]))
        r1 = srv.request_sync(ReleaseRequest(tenant="t0", marginals=margs[0]))
    finally:
        srv.stop()
        srv.ledger.close()
    for idx, r in enumerate((r0, r1)):
        direct = measure(plans[0], margs[0], _gen(request_seed(3, idx)),
                         device=CPU)
        for c in direct:
            assert np.array_equal(r.measurements[c].omega, direct[c].omega)
    c2 = next(c for c in plans[0].cliques if len(c) == 2)
    assert not np.array_equal(r0.tables[c2], r1.tables[c2])


def test_served_tables_match_jax_reconstruct(tmp_path):
    """Tables served by the port equal the JAX package's reconstruct of the
    same measurements within rel 2e-5 (one plan, identical σ², in both)."""
    from repro.core import Domain as JDomain
    from repro.core import all_kway as j_all_kway
    from repro.core import select as j_select
    from repro.core.mechanism import Measurement as JMeasurement
    from repro.core.reconstruct import reconstruct_all_batched as j_rec
    from repro_torch.convert import plan_arrays, plan_from_arrays
    jplan = j_select(j_all_kway(JDomain.create([5, 5, 5]), 2,
                                include_lower=True), pcost_budget=1.0)
    plans = [plan_from_arrays(*plan_arrays(jplan)) for _ in range(2)]
    margs = [marginals_from_records(DOM, plans[0].cliques,
                                    synthetic_records(DOM, 2000, seed=t))
             for t in range(2)]
    srv = _server(tmp_path, plans, max_batch=8)
    try:
        res = _paused_batch(srv, [ReleaseRequest(tenant=f"t{i}",
                                                 marginals=margs[i], seed=i)
                                  for i in range(2)])
    finally:
        srv.stop()
        srv.ledger.close()
    assert all(r.batched for r in res)
    for r in res:
        want = j_rec(jplan, {c: JMeasurement(c, m.omega, m.sigma2)
                             for c, m in r.measurements.items()})
        scale = max(float(np.abs(np.asarray(t)).max()) for t in want.values())
        for c, t in want.items():
            assert float(np.abs(r.tables[c] - np.asarray(t)).max()) \
                <= 2e-5 * scale, c


# ------------------------------------------------------------------- budgets
def test_over_budget_rejection_carries_exact_remaining_rho(tmp_path):
    plans, margs = _tenant_setup(1)
    per_release = pcost_of_plan(plans[0])
    # budget fits exactly 2 releases plus half of one more
    total = 2.5 * per_release
    srv = _server(tmp_path, plans, rho=total / 2.0)
    try:
        for s in range(2):
            srv.request_sync(ReleaseRequest(tenant="t0", marginals=margs[0],
                                            seed=s))
        fut = srv.submit(ReleaseRequest(tenant="t0", marginals=margs[0]))
        with pytest.raises(BudgetExhausted) as ei:
            fut.result(120)
        err = ei.value
        assert err.tenant == "t0"
        assert err.requested_pcost == pytest.approx(per_release)
        assert err.remaining_pcost == pytest.approx(0.5 * per_release)
        assert err.remaining_pcost == srv.ledger.remaining("t0")   # exact
        assert err.remaining_rho == pytest.approx(0.25 * per_release)
        # rejection is pre-measure: ledger unchanged, later top-up would work
        assert srv.ledger.spent("t0") == pytest.approx(2 * per_release)
        st = srv.stats_dict()
        assert st["tenants"]["t0"]["rejected_budget"] == 1
        assert st["tenants"]["t0"]["completed"] == 2
    finally:
        srv.stop()
        srv.ledger.close()


def test_budget_is_per_tenant(tmp_path):
    plans, margs = _tenant_setup(2)
    per = pcost_of_plan(plans[0])
    srv = _server(tmp_path, plans, rho=per / 2.0)   # exactly 1 release each
    try:
        srv.request_sync(ReleaseRequest(tenant="t0", marginals=margs[0]))
        with pytest.raises(BudgetExhausted):
            srv.request_sync(ReleaseRequest(tenant="t0",
                                            marginals=margs[0]))
        # t0 exhausted, t1 unaffected
        r = srv.request_sync(ReleaseRequest(tenant="t1", marginals=margs[1]))
        assert r.pcost_charged == pytest.approx(per)
    finally:
        srv.stop()
        srv.ledger.close()


def test_malformed_marginals_rejected_before_charge(tmp_path):
    """Marginals with missing cliques or wrong cell counts fail in phase 1,
    BEFORE the ledger is charged — and the worker survives to serve the next
    (valid) request."""
    plans, margs = _tenant_setup(1)
    srv = _server(tmp_path, plans)
    try:
        missing = {c: v for c, v in margs[0].items() if len(c) != 2}
        with pytest.raises(ValueError, match="missing clique"):
            srv.request_sync(ReleaseRequest(tenant="t0", marginals=missing))
        bad_shape = dict(margs[0])
        some_pair = next(c for c in plans[0].cliques if len(c) == 2)
        bad_shape[some_pair] = np.zeros(3)
        with pytest.raises(ValueError, match="cells, want"):
            srv.request_sync(ReleaseRequest(tenant="t0",
                                            marginals=bad_shape))
        # neither malformed request burned any budget
        assert srv.ledger.spent("t0") == 0.0
        # worker alive and still serving: a valid request goes through
        r = srv.request_sync(ReleaseRequest(tenant="t0", marginals=margs[0]))
        assert r.tables is not None
        assert srv.ledger.spent("t0") == pytest.approx(r.pcost_charged)
        st = srv.stats_dict()
        assert st["tenants"]["t0"]["failed"] == 2
        assert st["tenants"]["t0"]["completed"] == 1
    finally:
        srv.stop()
        srv.ledger.close()


def test_worker_survives_fused_path_failure(tmp_path, monkeypatch):
    """An unexpected exception inside the fused measure_multi path must not
    kill the worker: charged requests fall back to the solo path and still
    resolve (bit-identical, since both paths draw the same noise)."""
    import repro_torch.serve.server as server_mod

    def boom(items, use_kernel=None, dtype=None, device=None):
        raise RuntimeError("fused path exploded")

    plans, margs = _tenant_setup(2)
    srv = _server(tmp_path, plans, max_batch=8)
    try:
        monkeypatch.setattr(server_mod, "measure_multi", boom)
        res = _paused_batch(srv, [ReleaseRequest(tenant=f"t{i}",
                                                 marginals=margs[i],
                                                 seed=90 + i)
                                  for i in range(2)])
        assert not any(r.batched for r in res)     # solo fallback
        assert all(r.tables is not None for r in res)
        # worker alive; fused path restored serves the next batch normally
        monkeypatch.undo()
        r = srv.request_sync(ReleaseRequest(tenant="t0", marginals=margs[0],
                                            seed=90))
        for c in r.tables:
            assert np.array_equal(r.tables[c], res[0].tables[c])
    finally:
        srv.stop()
        srv.ledger.close()


def test_submit_after_stop_raises(tmp_path):
    plans, margs = _tenant_setup(1)
    srv = _server(tmp_path, plans)
    try:
        srv.request_sync(ReleaseRequest(tenant="t0", marginals=margs[0]))
    finally:
        srv.stop()
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit(ReleaseRequest(tenant="t0", marginals=margs[0]))
    srv.ledger.close()


def test_register_tenant_mid_traffic(tmp_path):
    """Registering tenants while the worker serves traffic must not corrupt
    the shared engine pool or the session map (lock-guarded)."""
    plans, margs = _tenant_setup(4)
    srv = _server(tmp_path, plans[:1])
    errors = []

    def hammer():
        try:
            for s in range(10):
                srv.request_sync(ReleaseRequest(tenant="t0",
                                                marginals=margs[0], seed=s))
        except Exception as exc:       # noqa: BLE001 — surfaced below
            errors.append(exc)

    t = None
    try:
        t = threading.Thread(target=hammer)
        t.start()
        for i in range(1, 4):
            srv.register_tenant(f"t{i}", plans[i], rho=100.0)
            srv.request_sync(ReleaseRequest(tenant=f"t{i}",
                                            marginals=margs[i]))
        t.join(120)
        assert not t.is_alive() and not errors
        assert set(srv.tenants()) == {"t0", "t1", "t2", "t3"}
        assert srv.stats_dict()["tenants"]["t0"]["completed"] == 10
    finally:
        if t is not None and t.is_alive():
            t.join(1)
        srv.stop()
        srv.ledger.close()


def test_unknown_tenant_and_bad_requests(tmp_path):
    plans, margs = _tenant_setup(1)
    srv = _server(tmp_path, plans)
    try:
        with pytest.raises(KeyError):
            srv.request_sync(ReleaseRequest(tenant="ghost",
                                            marginals=margs[0]))
        with pytest.raises(ValueError, match="needs marginals"):
            srv.request_sync(ReleaseRequest(tenant="t0"))
        with pytest.raises(ValueError, match="unknown request kind"):
            srv.request_sync(ReleaseRequest(tenant="t0", kind="nope",
                                            marginals=margs[0]))
        with pytest.raises(ValueError, match="RP\\+ plan"):
            srv.request_sync(ReleaseRequest(tenant="t0", kind="range",
                                            marginals=margs[0]))
        # failures consumed no budget
        assert srv.ledger.spent("t0") == 0.0
    finally:
        srv.stop()
        srv.ledger.close()


# ------------------------------------------------- postprocess + synthesis
def test_nonneg_release_then_synthesis_charges_nothing(tmp_path):
    plans, margs = _tenant_setup(1)
    srv = _server(tmp_path, plans)
    try:
        with pytest.raises(ValueError, match="non-negative release"):
            srv.request_sync(ReleaseRequest(tenant="t0", kind="synthesis",
                                            n_records=50))
        r = srv.request_sync(ReleaseRequest(tenant="t0", marginals=margs[0],
                                            postprocess="nonneg"))
        assert all(tab.min() >= 0 for tab in r.tables.values())
        spent = srv.ledger.spent("t0")
        s = srv.request_sync(ReleaseRequest(tenant="t0", kind="synthesis",
                                            n_records=200, seed=3))
        assert s.records.shape == (200, DOM.n_attrs)
        assert s.pcost_charged == 0.0
        assert srv.ledger.spent("t0") == spent   # synthesis is postprocessing
        # the synthesis draws from the request's seed, as the engine does
        again = srv.request_sync(ReleaseRequest(tenant="t0", kind="synthesis",
                                                n_records=200, seed=3))
        assert np.array_equal(s.records, again.records)
    finally:
        srv.stop()
        srv.ledger.close()


# ------------------------------------------------------------- stats + http
def test_stats_dict_and_http_endpoint(tmp_path):
    plans, margs = _tenant_setup(2)
    srv = _server(tmp_path, plans, max_batch=8)
    httpd = None
    try:
        _paused_batch(srv, [ReleaseRequest(tenant=f"t{i}", marginals=margs[i])
                            for i in range(2)])
        st = srv.stats_dict()
        assert st["requests_total"] == 2
        assert st["batch_occupancy"] == pytest.approx(2.0)
        assert st["tenants"]["t0"]["p50_ms"] is not None
        assert st["engine_cache"]["hit_rate"] is not None
        assert st["ledger"]["t0"]["charges"] == 1
        assert st["kernels"]["fused_chains"] >= 0
        assert st["autotune"]["device"] == "cpu"

        httpd, port = start_stats_http(srv)
        base = f"http://127.0.0.1:{port}"
        health = json.load(urllib.request.urlopen(f"{base}/healthz"))
        assert health["ok"] and set(health["tenants"]) == {"t0", "t1"}
        remote = json.load(urllib.request.urlopen(f"{base}/stats"))
        assert remote["requests_total"] == 2
        ledger = json.load(urllib.request.urlopen(f"{base}/ledger"))
        assert ledger["t1"]["charges"] == 1
    finally:
        if httpd is not None:
            httpd.shutdown()
        srv.stop()
        srv.ledger.close()


def test_healthz_reports_dead_worker_with_503(tmp_path):
    """/healthz is a liveness probe: 200 + ok while the worker thread runs,
    503 + ok=False once it is gone — the same condition submit() refuses on."""
    plans, margs = _tenant_setup(1)
    srv = _server(tmp_path, plans)
    httpd = None
    try:
        srv.request_sync(ReleaseRequest(tenant="t0", marginals=margs[0]))
        httpd, port = start_stats_http(srv)
        base = f"http://127.0.0.1:{port}"
        health = json.load(urllib.request.urlopen(f"{base}/healthz"))
        assert health["ok"] and health["worker_alive"]
        assert health["queue_depth"] == 0
        assert health["uptime_s"] >= 0
        srv.stop()                          # worker dead, HTTP still up
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/healthz")
        assert ei.value.code == 503
        body = json.load(ei.value)
        assert body["ok"] is False and body["worker_alive"] is False
    finally:
        if httpd is not None:
            httpd.shutdown()
        srv.stop()
        srv.ledger.close()


def test_trace_id_propagates_serve_to_kernel(tmp_path):
    """One traced request yields ONE connected span tree: the trace ID minted
    at submit() reaches the kernel.chain spans inside the fused call, and
    every span's parent is another span of the same trace."""
    from repro_torch.obs import TRACER
    plans, margs = _tenant_setup(2)
    TRACER.enable()                         # in-memory ring, no file sink
    TRACER.drain()
    try:
        srv = _server(tmp_path, plans, max_batch=8, use_kernel=True)
        try:
            res = _paused_batch(srv, [ReleaseRequest(tenant=f"t{i}",
                                                     marginals=margs[i],
                                                     seed=i)
                                      for i in range(2)])
            assert all(r.batched for r in res)
        finally:
            srv.stop()
            srv.ledger.close()
        spans = TRACER.drain()
    finally:
        TRACER.disable()

    by_trace = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    roots = [s for s in spans if s.name == "serve.request"]
    assert len(roots) == 2                  # one root per request
    assert len({r.trace_id for r in roots}) == 2
    for root in roots:
        tree = by_trace[root.trace_id]
        ids = {s.span_id for s in tree}
        orphans = [s for s in tree
                   if s.parent_id is not None and s.parent_id not in ids]
        assert not orphans                  # fully connected tree
        names = {s.name for s in tree}
        assert {"serve.request", "serve.queue_wait", "serve.charge",
                "serve.fuse"} <= names
        assert root.attrs["outcome"] == "completed"
    # the fused call's kernel spans ride the batch leader's trace
    kernel_spans = [s for s in spans if s.name == "kernel.chain"]
    assert kernel_spans
    assert all(s.trace_id in by_trace for s in kernel_spans)
    leader = [s for s in spans if s.name == "serve.fuse"
              and not s.attrs.get("shared")]
    assert leader and any(s.trace_id == leader[0].trace_id
                          and s.attrs.get("fused") is not None
                          for s in kernel_spans)


def test_metrics_endpoint_parseable_under_concurrent_traffic(tmp_path):
    """16 threads of mixed traffic + /metrics scrapes: every scrape parses,
    and the final exposition agrees with /stats (one backing store)."""
    from repro_torch.obs import parse_exposition
    plans, margs = _tenant_setup(4)
    srv = _server(tmp_path, plans, max_batch=8)
    httpd = None
    errors = []
    try:
        httpd, port = start_stats_http(srv)
        base = f"http://127.0.0.1:{port}"

        def submit(i):
            try:
                for s in range(3):
                    srv.request_sync(ReleaseRequest(
                        tenant=f"t{i % 4}", marginals=margs[i % 4],
                        seed=100 * i + s))
            except Exception as exc:       # noqa: BLE001 — surfaced below
                errors.append(exc)

        def scrape():
            try:
                for _ in range(10):
                    with urllib.request.urlopen(f"{base}/metrics") as resp:
                        assert resp.headers["Content-Type"].startswith(
                            "text/plain; version=0.0.4")
                        parse_exposition(resp.read().decode())
            except Exception as exc:       # noqa: BLE001 — surfaced below
                errors.append(exc)

        threads = ([threading.Thread(target=submit, args=(i,))
                    for i in range(8)]
                   + [threading.Thread(target=scrape) for _ in range(8)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]

        # /metrics and /stats read the same store -> identical numbers
        with urllib.request.urlopen(f"{base}/metrics") as resp:
            parsed = parse_exposition(resp.read().decode())
        st = srv.stats_dict()
        req = parsed["repro_serve_requests_total"]
        for tname, tstats in st["tenants"].items():
            assert req.get(f'tenant="{tname}",outcome="completed"',
                           0) == tstats["completed"]
        assert parsed["repro_serve_batches_total"][""] == st["batches"]
        for tname, led in st["ledger"].items():
            assert parsed["repro_ledger_charges_total"][
                f'tenant="{tname}"'] == led["charges"]
            assert parsed["repro_ledger_pcost_spent"][
                f'tenant="{tname}"'] == pytest.approx(led["pcost_spent"])
    finally:
        if httpd is not None:
            httpd.shutdown()
        srv.stop()
        srv.ledger.close()


def test_stats_scraped_from_8_threads_during_traffic(tmp_path):
    """/stats (tuner registry snapshot, chain counters, pool, ledger) from 8
    HTTP threads while the worker serves drains of changing sizes, which
    insert new tuner keys: no scrape fails."""
    from repro_torch.kernels.autotune import registry_snapshot
    plans, margs = _tenant_setup(6)
    srv = _server(tmp_path, plans, max_batch=8)
    httpd = None
    errors, done = [], threading.Event()
    try:
        httpd, port = start_stats_http(srv)
        base = f"http://127.0.0.1:{port}"

        def scrape():
            try:
                while not done.is_set():
                    with urllib.request.urlopen(f"{base}/stats") as resp:
                        body = json.load(resp)
                    assert "kernels" in body and "autotune" in body
            except Exception as exc:       # noqa: BLE001 — surfaced below
                errors.append(exc)

        scrapers = [threading.Thread(target=scrape) for _ in range(8)]
        for t in scrapers:
            t.start()
        for n in range(1, 7):               # drains of 1..6 requests
            _paused_batch(srv, [ReleaseRequest(tenant=f"t{i}",
                                               marginals=margs[i], seed=n)
                                for i in range(n)])
        done.set()
        for t in scrapers:
            t.join(60)
        assert not any(t.is_alive() for t in scrapers)
        assert not errors, errors[:3]
        assert registry_snapshot(CPU)["entries"]
    finally:
        done.set()
        if httpd is not None:
            httpd.shutdown()
        srv.stop()
        srv.ledger.close()


def test_metrics_family_names_match_jax_server(tmp_path):
    """After the same traffic, the port's server registry exposes the JAX
    server's family names and series labels, with equal request and ledger
    counts; the port's merged /metrics holds the shared global families."""
    from repro.core import all_kway as j_all_kway
    from repro.core import select as j_select
    from repro.core.domain import Domain as JDomain
    from repro.serve import BudgetLedger as JLedger
    from repro.serve import ReleaseRequest as JRequest
    from repro.serve import ReleaseServer as JServer
    from repro_torch.obs import exposition, parse_exposition
    jplan = j_select(j_all_kway(JDomain.create([5, 5, 5]), 2,
                                include_lower=True), pcost_budget=1.0)
    plans, margs = _tenant_setup(2)
    per = pcost_of_plan(plans[0])

    def traffic(srv, req_cls):
        srv.pause()
        futs = [srv.submit(req_cls(tenant=f"t{i}", marginals=margs[i],
                                   seed=i)) for i in range(2)]
        srv.resume()
        [f.result(300) for f in futs]
        with pytest.raises(Exception):          # over budget: rejected
            srv.request_sync(req_cls(tenant="t0", marginals=margs[0]))
        srv.stop()
        srv.ledger.close()
        return (parse_exposition(exposition(srv.metrics)),
                set(re.findall(r"^# TYPE (\S+) ", srv.metrics_text(), re.M)))

    jsrv = JServer(JLedger(str(tmp_path / "j.jsonl"), fsync=False),
                   max_batch=8).start()
    for i in range(2):
        jsrv.register_tenant(f"t{i}", jplan, pcost=1.5 * per)
    jserved, jall = traffic(jsrv, JRequest)
    tsrv = _server(tmp_path, plans, max_batch=8)
    tsrv.ledger.register("t0", pcost=1.5 * per)
    tsrv.ledger.register("t1", pcost=1.5 * per)
    tserved, tall = traffic(tsrv, ReleaseRequest)
    assert set(tserved) == set(jserved)
    for fam in jserved:
        assert set(tserved[fam]) == set(jserved[fam]), fam
    for fam in ("repro_serve_requests_total", "repro_serve_batches_total",
                "repro_serve_batched_requests_total",
                "repro_ledger_charges_total", "repro_ledger_rejects_total"):
        assert tserved[fam] == jserved[fam], fam
    # the JAX server ran its plain chains (no kernel families of its own);
    # the port has no launch histogram (a chain call reads no clock)
    shared = {"repro_engine_events_total", "repro_kernel_events_total",
              "repro_engine_cache_events_total"}
    assert "repro_kernel_launch_seconds" not in tall
    assert shared <= tall and jall & shared <= tall
    assert "repro_engine_events_total" in jall


# ---------------------------------------------------------------- warm pool
def test_engine_pool_caches_and_counts(tmp_path):
    plans, _ = _tenant_setup(2)
    pool = EnginePool(maxsize=4)
    e0 = pool.engine_for("a", plans[0], device=CPU)
    assert pool.engine_for("a", plans[0], device=CPU) is e0       # hit
    assert pool.engine_for("b", plans[0], device=CPU) is e0       # cross-tenant
    assert pool.engine_for("b", plans[1], device=CPU) is not e0
    assert e0.device.type == "cpu" and e0.use_kernel
    s = pool.stats()
    assert s["hits"] == 2 and s["misses"] == 2 and s["entries"] == 2


def test_engine_pool_pins_hot_and_evicts_cold():
    wk_a = all_kway(Domain.create([4, 3]), 2, include_lower=True)
    plans = [select(all_kway(DOM, 2, include_lower=True), pcost_budget=1.0)
             for _ in range(3)] + [select(wk_a, pcost_budget=1.0)]
    pool = EnginePool(maxsize=2, pin_count=1)
    hot = pool.engine_for("a", plans[0], device=CPU)
    for _ in range(5):                       # "a" hammers plan 0 -> hot, pinned
        pool.engine_for("a", plans[0], device=CPU)
    assert len(pool.cache._pinned) == 1
    pool.engine_for("b", plans[1], device=CPU)     # fills the cache
    pool.engine_for("c", plans[2], device=CPU)     # evicts ... someone unpinned
    pool.engine_for("d", plans[3], device=CPU)
    assert pool.cache.evictions == 2
    assert pool.engine_for("a", plans[0], device=CPU) is hot  # hot survived
    assert pool.stats()["snapshot"]          # snapshot renders


def test_engine_cache_device_key_names_one_device(monkeypatch):
    """None, "cuda" and "cuda:<current>" key one entry; "cpu" another."""
    from repro_torch.engine.sharded import _EngineCache

    class _P:
        pass

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cache, p = _EngineCache(maxsize=4), _P()
    keys = {cache._key(p, True, torch.float32, device=d)
            for d in (None, "cuda", "cuda:0", torch.device("cuda"),
                      torch.device("cuda", 0))}
    assert len(keys) == 1 and next(iter(keys))[-1] == "cuda:0"
    assert cache._key(p, True, torch.float32, device="cpu") not in keys
    assert cache._key(p, True, torch.float32, device="cuda:1") not in keys


def test_engine_cache_weighted_eviction_prefers_low_score():
    from repro_torch.engine.sharded import _EngineCache

    class _P:                                # minimal plan stand-in
        def engine(self, **kw):
            raise AssertionError("not used")

    cache = _EngineCache(maxsize=2)
    p1, p2, p3 = _P(), _P(), _P()
    cache.put(p1, False, torch.float32, "e1", device=CPU)
    cache.put(p2, False, torch.float32, "e2", device=CPU)
    scores = {cache._key(p1, False, torch.float32, device=CPU): 5.0,
              cache._key(p2, False, torch.float32, device=CPU): 1.0}
    cache.evict_score = lambda k: scores.get(k, 0.0)
    cache.put(p3, False, torch.float32, "e3", device=CPU)  # evicts p2
    assert cache.get(p1, False, torch.float32, device=CPU) == "e1"
    assert cache.get(p2, False, torch.float32, device=CPU) is None
    assert cache.evictions == 1


def test_engine_cache_pinned_entry_survives_lru():
    from repro_torch.engine.sharded import _EngineCache

    class _P:
        def engine(self, **kw):
            raise AssertionError("not used")

    cache = _EngineCache(maxsize=2)
    keep, other, third = _P(), _P(), _P()
    cache.put(keep, False, torch.float32, "keep", device=CPU)
    cache.pin(keep, False, torch.float32, device=CPU)
    cache.put(other, False, torch.float32, "other", device=CPU)
    cache.put(third, False, torch.float32, "third", device=CPU)  # LRU: "keep"
    assert cache.get(keep, False, torch.float32, device=CPU) == "keep"
    assert cache.get(other, False, torch.float32, device=CPU) is None
    # all-pinned cache still makes room (advisory pins)
    cache.pin(third, False, torch.float32, device=CPU)
    fourth = _P()
    cache.put(fourth, False, torch.float32, "fourth", device=CPU)
    assert cache.forced_evictions == 1


# ------------------------------------------------------------------ launch
def test_launch_serve_once_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.serve --once --device cpu`` serves its
    demo traffic (2 Adult ≤2-way tenants, 1 request each) and exits 0."""
    ledger = str(tmp_path / "ledger.jsonl")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--once",
         "--device", "cpu", "--tenants", "2", "--requests", "1", "--port",
         "0", "--ledger", ledger], capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "2 tenants registered on cpu" in out.stdout
    summary = json.loads(out.stdout.split("[serve] demo traffic: ")[1]
                         .splitlines()[0])
    assert summary["requests"] == 2
    replay = BudgetLedger(ledger)
    assert replay.tenants == ("tenant-0", "tenant-1")
    assert all(replay.report(t)["charges"] == 1 for t in replay.tenants)
    replay.close()
