"""Async multi-tenant release server: queue → charge → fuse → serve.

The port of ``repro.serve.server``.  Every served request runs on the
server's device (CUDA unless ``device="cpu"``), through the two hand-written
kernels unless ``use_kernel=False``.

The worker loop drains the request queue in small batches (up to
``max_batch`` requests, waiting at most ``max_wait_ms`` after the first to
let a batch fill), then serves a batch in three phases:

1. **validate + charge** — every request's marginals are validated against
   the tenant's plan closure (keys + cell counts), and only then charged
   against the durable ledger *before anything is measured*
   (charge-before-measure, :mod:`repro_torch.serve.ledger`) — a malformed request
   never burns budget.  Over-budget requests fail immediately with the exact
   remaining ρ; their future carries the
   :class:`~repro_torch.core.accountant.BudgetExhausted`.
2. **fuse** — charged release requests whose plans are cross-request fusable
   (plain marginal plans, :func:`repro_torch.engine.multi.can_fuse`) ride ONE
   chain call per distinct per-axis signature across the whole batch
   (:func:`repro_torch.engine.multi.measure_multi`); RP+/composite/secure
   requests are served per-request through the tenant-weighted engine pool.
3. **serve** — per-request reconstruction through the pooled compiled
   engines, optional postprocessing (consistency / non-negativity), and
   synthesis from the tenant's last non-negative release.

Noise: every request draws from its own ``torch.Generator`` on the
server's device.  An explicit ``seed=`` seeds it with ``manual_seed(seed)``,
so a served measurement equals ``measure(plan, margs, gen)`` for a generator
seeded alike, bit for bit (batched or not).  A request with ``seed=None``
gets the seed :func:`request_seed` derives from the server's ``noise_seed``
and a monotonically increasing request counter: a bijection of the counter,
so two requests of one server never share noise unless the caller forces a
seed.  torch generators are not JAX's threefry keys, so served noise differs
from the JAX server's by design.
"""
from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.accountant import BudgetExhausted
from repro_torch.core.domain import Clique
from repro_torch.core.mechanism import noise_dtype, pcost_of_plan
from repro_torch.engine.multi import can_fuse, measure_multi
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.obs import REGISTRY, TRACER, exposition
from repro_torch.serve.ledger import BudgetLedger, UnknownTenant
from repro_torch.serve.pool import EnginePool
from repro_torch.serve.stats import ServerStats

RELEASE_KINDS = ("marginal", "range")

_MASK32 = (1 << 32) - 1


def _mix32(x: int) -> int:
    """A bijection of 32-bit integers (xorshifts and odd multipliers)."""
    x ^= x >> 16
    x = x * 0x7FEB352D & _MASK32
    x ^= x >> 15
    x = x * 0x846CA68B & _MASK32
    return x ^ (x >> 16)


def request_seed(noise_seed: int, index: int) -> int:
    """The 64-bit generator seed of the server-assigned request ``index``.

    A 64-bit key from ``np.random.SeedSequence(noise_seed)`` is XORed with
    the index, and each 32-bit half is mixed by a bijection: deterministic,
    two indices below 2^64 never share a seed, and two below 2^32 never
    share its low 32 bits (all that torch's CPU generator reads of a seed;
    the CUDA generator reads all 64).
    """
    key = int(np.random.SeedSequence(noise_seed).generate_state(
        1, np.uint64)[0])
    x = key ^ (int(index) & ((1 << 64) - 1))
    return (_mix32(x >> 32) << 32) | _mix32(x & _MASK32)


@dataclass
class ReleaseRequest:
    """One tenant request.

    ``kind="marginal"`` / ``"range"`` release the tenant's registered
    workload from the supplied exact marginal tables (``"range"`` merely
    asserts the tenant holds an RP+ plan); ``kind="synthesis"`` samples
    ``n_records`` rows from the tenant's last ``postprocess="nonneg"``
    release (no new measurement → no budget charge).
    """

    tenant: str
    kind: str = "marginal"
    marginals: Optional[Mapping[Clique, np.ndarray]] = None
    postprocess: Optional[str] = None
    n_records: int = 0
    seed: Optional[int] = None
    cliques: Optional[Sequence[Clique]] = None    # reconstruct subset


@dataclass
class ReleaseResult:
    """What a resolved request future carries."""

    tenant: str
    kind: str
    tables: Optional[Dict[Clique, np.ndarray]] = None
    measurements: Optional[dict] = None
    records: Optional[np.ndarray] = None
    pcost_charged: float = 0.0
    batched: bool = False           # served inside a fused multi-request batch
    batch_size: int = 1
    latency_s: float = 0.0


@dataclass
class _TenantSession:
    plan: object
    secure: bool = False
    digits: int = 4
    synth_tables: Optional[dict] = None
    pcost_per_release: float = 0.0


@dataclass
class _Pending:
    request: ReleaseRequest
    future: Future
    t_submit: float
    index: int                       # global request counter (noise fold)
    session: Optional[_TenantSession] = None
    measurements: Optional[dict] = None
    batched: bool = False
    charged: float = 0.0
    trace: Optional[object] = None   # root serve.request span (tracing on)


class ReleaseServer:
    """Multi-tenant serving tier over the plan → measure → release pipeline.

    Parameters
    ----------
    ledger:       durable per-tenant budget ledger (charge-before-measure).
    max_batch:    worker drain size; 1 disables cross-tenant fusion.
    max_wait_ms:  how long the worker lingers after the first request to let
                  a batch fill (0 = serve whatever is already queued).
    use_kernel:   run the chains on the hand-written kernels (default;
                  their plain versions on the CPU) or the plain batched
                  torch path (False).
    pool:         engine warm pool; default ``EnginePool()`` (capacity from
                  ``REPRO_ENGINE_CACHE_SIZE``).
    noise_seed:   base of the server-assigned per-request seeds
                  (:func:`request_seed`).
    device:       ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.
    """

    def __init__(self, ledger: BudgetLedger, max_batch: int = 16,
                 max_wait_ms: float = 2.0, use_kernel: Optional[bool] = None,
                 dtype=None, pool: Optional[EnginePool] = None,
                 noise_seed: int = 0, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.ledger = ledger
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.device = resolve_device(device)
        self.use_kernel = True if use_kernel is None else bool(use_kernel)
        self.dtype = noise_dtype() if dtype is None else dtype
        self.pool = EnginePool() if pool is None else pool
        self.stats = ServerStats()
        # The server-private metrics registry (tenant-scoped series); the
        # ledger mirrors its charge/reject/spend series into the same store
        # so /metrics and /ledger can never disagree.
        self.metrics = self.stats.registry
        self.ledger.bind_registry(self.metrics)
        self._started_at: Optional[float] = None
        self.noise_seed = int(noise_seed)
        self._sessions: Dict[str, _TenantSession] = {}  # guarded-by: _sessions_lock
        self._sessions_lock = threading.Lock()
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._counter = 0                              # guarded-by: _counter_lock
        self._counter_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._resume_evt = threading.Event()
        self._resume_evt.set()
        self._worker: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReleaseServer":
        if self._worker is None or not self._worker.is_alive():
            self._stop_evt.clear()
            if self._started_at is None:
                self._started_at = time.monotonic()
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="release-server-worker",
                                            daemon=True)
            self._worker.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        # joining the queue of a dead worker would hang forever
        if drain and self._worker is not None and self._worker.is_alive():
            self._queue.join()
        self._stop_evt.set()
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None

    def pause(self) -> None:
        """Hold the worker so the queue can be prefilled (tests, benchmarks)."""
        self._resume_evt.clear()

    def resume(self) -> None:
        self._resume_evt.set()

    def __enter__(self) -> "ReleaseServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    # ------------------------------------------------------------- tenants
    def register_tenant(self, tenant: str, plan, rho: Optional[float] = None,
                        pcost: Optional[float] = None, secure: bool = False,
                        digits: int = 4, warm: bool = True) -> None:
        """Register a tenant: durable budget + serving plan (+ warm engine).

        ``rho``/``pcost`` set the tenant's total budget exactly as
        :meth:`BudgetLedger.register`.  ``secure=True`` serves this tenant
        through the discrete-Gaussian engine (charged the exact discrete
        pcost, always ≤ continuous).  ``warm=True`` compiles the engine into
        the pool now so the first request is a cache hit.

        Thread-safe against a running worker: the session map and the engine
        pool are lock-guarded, so tenants may be registered mid-traffic.
        """
        self.ledger.register(tenant, rho=rho, pcost=pcost)
        if secure:
            from repro_torch.core.discrete import discrete_pcost_of_plan
            per_release = discrete_pcost_of_plan(plan, digits)
        else:
            per_release = pcost_of_plan(plan)
        with self._sessions_lock:
            self._sessions[tenant] = _TenantSession(
                plan=plan, secure=secure, digits=digits,
                pcost_per_release=per_release)
        if warm:
            self.pool.engine_for(tenant, plan, self.use_kernel, self.dtype,
                                 secure, digits, self.device)

    def tenants(self) -> tuple:
        with self._sessions_lock:
            return tuple(self._sessions)

    # -------------------------------------------------------------- submit
    def submit(self, request: ReleaseRequest) -> Future:
        """Enqueue a request; the returned future resolves to a
        :class:`ReleaseResult` or raises the serving error (over-budget →
        :class:`~repro_torch.core.accountant.BudgetExhausted`)."""
        if self._worker is None or not self._worker.is_alive():
            raise RuntimeError(
                "server worker is not running: call start() first (a worker "
                "that was running has died or been stopped — restarting via "
                "start() is safe; queued budget charges are already durable)")
        fut: Future = Future()
        with self._counter_lock:
            idx = self._counter
            self._counter += 1
        trace = None
        if TRACER.enabled:
            # Root span of the request's trace tree: minted here, carried on
            # the queued item, ended by the worker when the future resolves.
            trace = TRACER.span("serve.request").set(
                tenant=request.tenant, kind=request.kind, index=idx)
        self.stats.enqueue()
        self._queue.put(_Pending(request, fut, time.monotonic(), idx,
                                 trace=trace))
        return fut

    def request_sync(self, request: ReleaseRequest,
                     timeout: Optional[float] = 120.0) -> ReleaseResult:
        return self.submit(request).result(timeout)

    def stats_dict(self) -> dict:
        d = self.stats.to_dict(cache=self.pool.cache, ledger=self.ledger)
        # Kernel-tier observability: the process-wide launch and route
        # counters and the autotuner decisions in effect on this device.
        from repro_torch.kernels.autotune import registry_snapshot
        from repro_torch.kernels.kron_matvec.stats import chain_stats
        d["kernels"] = chain_stats()
        d["autotune"] = registry_snapshot(self.device)
        return d

    def health(self) -> dict:
        """Liveness snapshot for /healthz: worker state, queue depth, uptime.

        ``ok`` is False exactly when the worker thread is not alive — the
        same condition under which :meth:`submit` refuses new requests — so
        a load balancer polling /healthz stops routing before clients see
        the RuntimeError.
        """
        alive = self._worker is not None and self._worker.is_alive()
        uptime = (time.monotonic() - self._started_at
                  if self._started_at is not None else 0.0)
        return {"ok": alive, "worker_alive": alive,
                "queue_depth": self.stats.queue_depth,
                "uptime_s": uptime, "tenants": list(self.tenants())}

    def metrics_text(self) -> str:
        """Prometheus exposition: server registry merged with the global one
        (kernel events, engine aggregates, launch timings)."""
        return exposition(self.metrics, REGISTRY)

    # -------------------------------------------------------------- worker
    def _worker_loop(self) -> None:
        while not self._stop_evt.is_set():
            if not self._resume_evt.wait(timeout=0.05):
                continue
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            # pause() may land while we were already blocked in get() above,
            # past the resume check: hold the first request until resumed so
            # a prefilled queue always drains as one batch.
            while (not self._resume_evt.is_set()
                   and not self._stop_evt.is_set()):
                self._resume_evt.wait(timeout=0.05)
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._queue.get(
                        timeout=max(0.0, deadline - time.monotonic())))
                except queue.Empty:
                    break
            self.stats.dequeue(len(batch))
            try:
                with TRACER.span("serve.batch") as sp:
                    groups = self._serve_batch(batch)
                    if sp:
                        sp.set(requests=len(batch), groups=groups)
            except Exception as exc:   # noqa: BLE001 — never kill the worker
                # _serve_batch fails individual requests through their
                # futures; anything escaping it is a bug, but dying here
                # would strand every in-flight future (and deadlock
                # stop(drain=True)), so deliver the error and keep serving.
                for p in batch:
                    self._fail(p, exc)
            finally:
                for _ in batch:
                    self._queue.task_done()

    def _gen_for(self, p: _Pending) -> torch.Generator:
        """A fresh generator of the request's noise on the server's device:
        ``manual_seed(seed)`` for an explicit seed, else
        :func:`request_seed` of the request's index.  Fresh on every call,
        so the solo fallback of a failed fused batch draws the same noise."""
        seed = (p.request.seed if p.request.seed is not None
                else request_seed(self.noise_seed, p.index))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _fail(self, p: _Pending, exc: Exception) -> None:
        if p.future.done():            # already resolved (or failed) earlier
            return
        outcome = ("rejected_budget" if isinstance(exc, BudgetExhausted)
                   else "failed")
        self.stats.tenant(p.request.tenant).record(outcome)
        if p.trace:
            p.trace.set(outcome=outcome, error=type(exc).__name__)
            p.trace.end()
        p.future.set_exception(exc)

    @staticmethod
    def _validate_marginals(sess: _TenantSession, req: ReleaseRequest) -> None:
        """Reject malformed marginals BEFORE any budget is charged.

        Every clique of the tenant's plan closure must be present with the
        right cell count — the same contract every engine's ``measure``
        enforces, checked here so a malformed-but-present payload fails
        without burning the tenant's budget.
        """
        plan = sess.plan
        for c in plan.cliques:
            if c not in req.marginals:
                raise ValueError(
                    f"marginals missing clique {c!r}: the plan closure "
                    f"needs all of {list(plan.cliques)!r} (nothing charged)")
            got = int(np.asarray(req.marginals[c]).size)
            want = plan.domain.n_cells(c)
            if got != want:
                raise ValueError(
                    f"marginal for {c!r} has {got} cells, want {want} "
                    f"(nothing charged)")

    def _serve_batch(self, batch) -> int:
        """Serve one drained batch; returns its fused signature groups."""
        # Queue wait: an interval that started on the submitting thread —
        # recorded with an explicit t0 against each request's own trace.
        if TRACER.enabled:
            t_drain = time.monotonic()
            for p in batch:
                if p.trace:
                    TRACER.span("serve.queue_wait", parent=p.trace,
                                t0=p.t_submit).set(
                        batch_size=len(batch)).end(t_drain)

        # ---- phase 1: validate, then charge-before-measure ---------------
        charged: list = []
        for p in batch:
            req = p.request
            try:
                with self._sessions_lock:
                    sess = self._sessions.get(req.tenant)
                if sess is None:
                    raise UnknownTenant(req.tenant)
                p.session = sess
                if req.kind in RELEASE_KINDS:
                    if req.marginals is None:
                        raise ValueError(
                            f"{req.kind!r} request needs marginals=")
                    if req.kind == "range" and can_fuse(sess.plan):
                        raise ValueError(
                            "kind='range' needs an RP+ plan; this tenant "
                            "registered a plain marginal plan")
                    self._validate_marginals(sess, req)
                    p.charged = sess.pcost_per_release
                    with TRACER.span("serve.charge", parent=p.trace).set(
                            tenant=req.tenant, pcost=p.charged):
                        self.ledger.charge(req.tenant, p.charged,
                                           request_id=f"req-{p.index}")
                elif req.kind == "synthesis":
                    if sess.synth_tables is None:
                        raise ValueError(
                            "no non-negative release to sample from: submit "
                            "a release with postprocess='nonneg' first")
                    p.charged = 0.0          # postprocessing only
                else:
                    raise ValueError(f"unknown request kind {req.kind!r}")
                charged.append(p)
            except Exception as exc:         # noqa: BLE001 — fail THIS request
                self._fail(p, exc)

        # ---- phase 2: fuse same-signature release traffic ----------------
        fusable = [p for p in charged
                   if p.request.kind in RELEASE_KINDS
                   and can_fuse(p.session.plan) and not p.session.secure]
        fused_groups = 0
        if len(fusable) >= 2:
            items = [(p.session.plan, p.request.marginals, self._gen_for(p))
                     for p in fusable]
            # The fused launch serves every fusable request at once, but a
            # span tree needs ONE parent: the batch leader's trace hosts the
            # real serve.fuse span (kernel/group spans nest under it); every
            # other request gets a same-interval serve.fuse marker pointing
            # at the leader's trace, so its tree stays connected and its
            # critical path still accounts the fused time.
            leader = fusable[0]
            t_fuse0 = time.monotonic()
            fuse_ctx = (TRACER.activate(leader.trace) if leader.trace
                        else contextlib.nullcontext())
            try:
                with fuse_ctx, TRACER.span(
                        "serve.fuse", parent=leader.trace).set(
                        requests=len(fusable)):
                    measured = measure_multi(items,
                                             use_kernel=self.use_kernel,
                                             dtype=self.dtype,
                                             device=self.device)
            except Exception:          # noqa: BLE001 — fused path is optional
                # Phase-1 validation makes this unreachable for bad request
                # payloads, but an unexpected fused-path failure must not
                # strand already-charged futures: fall back to the solo path
                # (p.measurements stays None), where a genuinely bad request
                # fails alone in phase 3 and the rest of the batch serves.
                pass
            else:
                t_fuse1 = time.monotonic()
                sigs = set()
                for plan, _m, _k in items:
                    for c in plan.cliques:
                        sigs.add(tuple(plan.domain.attributes[a].size
                                       for a in c))
                fused_groups = len(sigs)
                for p, meas in zip(fusable, measured):
                    p.measurements = meas
                    p.batched = True
                    if p.trace and p is not leader:
                        TRACER.span("serve.fuse", parent=p.trace,
                                    t0=t_fuse0).set(
                            shared=True, requests=len(fusable),
                            launch_trace=leader.trace.trace_id
                            if leader.trace else None).end(t_fuse1)
        self.stats.record_batch(len(batch), fused_groups)

        # ---- phase 3: per-request serve ----------------------------------
        for p in charged:
            ctx = (TRACER.activate(p.trace) if p.trace
                   else contextlib.nullcontext())
            try:
                with ctx:
                    result = self._serve_one(p, len(batch))
            except Exception as exc:         # noqa: BLE001 — fail THIS request
                self._fail(p, exc)
            else:
                self.stats.tenant(p.request.tenant).record(
                    "completed", batched=p.batched,
                    latency_s=result.latency_s)
                if p.trace:
                    p.trace.set(outcome="completed", batched=p.batched,
                                batch_size=len(batch))
                    p.trace.end()
                p.future.set_result(result)
        return fused_groups

    def _serve_one(self, p: _Pending, batch_size: int) -> ReleaseResult:
        req, sess = p.request, p.session
        if req.kind == "synthesis":
            from repro_torch.release import synthesize_records
            with TRACER.span("serve.synthesize").set(
                    tenant=req.tenant, n_records=req.n_records):
                records = synthesize_records(sess.plan.domain,
                                             sess.synth_tables,
                                             req.n_records, self._gen_for(p),
                                             device=self.device)
            return ReleaseResult(req.tenant, req.kind, records=records,
                                 batch_size=batch_size,
                                 latency_s=time.monotonic() - p.t_submit)
        engine = self.pool.engine_for(req.tenant, sess.plan, self.use_kernel,
                                      self.dtype, sess.secure, sess.digits,
                                      self.device)
        meas = p.measurements
        if meas is None:                      # solo path (RP+/secure/batch=1)
            meas = engine.measure(req.marginals, self._gen_for(p))
        tables = engine.reconstruct(meas, req.cliques) if req.cliques \
            else engine.reconstruct(meas)
        if req.postprocess is not None:
            engine._check_postprocess()
            from repro_torch.release import postprocess_release
            tables = postprocess_release(
                sess.plan, tables, req.postprocess,
                total=engine._postprocess_total(meas), device=self.device,
                use_kernel=self.use_kernel)
            engine.stats.bump("postprocess_calls")
            if req.postprocess == "nonneg":
                sess.synth_tables = tables
        return ReleaseResult(req.tenant, req.kind, tables=tables,
                             measurements=meas, pcost_charged=p.charged,
                             batched=p.batched, batch_size=batch_size,
                             latency_s=time.monotonic() - p.t_submit)


# --------------------------------------------------------------------- http
class _StatsHandler(BaseHTTPRequestHandler):
    server_ref: Optional[ReleaseServer] = None

    def log_message(self, *args) -> None:   # silence per-request stderr spam
        pass

    def do_GET(self) -> None:               # noqa: N802 (stdlib API name)
        srv = self.server_ref
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        status = 200
        ctype = "application/json"
        if path == "/stats":
            body = json.dumps(srv.stats_dict(), indent=2, default=str)
        elif path == "/ledger":
            body = json.dumps(srv.ledger.report(), indent=2, default=str)
        elif path == "/metrics":
            body = srv.metrics_text()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path in ("/", "/healthz"):
            health = srv.health()
            body = json.dumps(health)
            if not health["ok"]:      # dead worker: stop routing traffic here
                status = 503
        else:
            self.send_error(404)
            return
        data = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def start_stats_http(server: ReleaseServer, host: str = "127.0.0.1",
                     port: int = 0):
    """Serve ``/stats``, ``/ledger``, ``/healthz``, ``/metrics`` for
    ``server``.

    ``/metrics`` is Prometheus text format;
    ``/healthz`` returns 503 while the worker thread is dead.  Returns
    ``(httpd, bound_port)``; the HTTP server runs on a daemon thread (stdlib
    only — no framework dependency).  Port 0 binds an ephemeral port.
    """
    handler = type("_Bound", (_StatsHandler,), {"server_ref": server})
    httpd = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="release-server-http")
    t.start()
    return httpd, httpd.server_address[1]
