"""Serving observability: per-tenant and server-wide counters for /stats.

The port of ``repro.serve.stats``, with the JAX package's metric family
names, so one ``/metrics`` scrape reads the same whichever package serves.

Since the obs subsystem (docs/OBSERVABILITY.md) the *store* is a
:class:`~repro_torch.obs.MetricsRegistry` — each server owns one, so two servers in
a process never cross-pollute tenant series — and this module is the thin
view layer over it: ``TenantStats`` / ``ServerStats`` keep their historical
field surface (``completed``, ``rejected_budget``, ``batch_occupancy``, …)
while ``/metrics`` renders the identical cells in Prometheus text format.
The two endpoints cannot disagree; there is only one store.

Metric names:

* ``repro_serve_requests_total{tenant,outcome}`` —
  outcome ∈ completed / rejected_budget / failed.
* ``repro_serve_batched_requests_total{tenant}`` — served inside a fused
  multi-request batch.
* ``repro_serve_latency_seconds{tenant}`` — summary over a bounded ring
  (default 4096 samples/tenant, O(1) memory for a long-lived server);
  p50/p99 are computed over the ring on demand, exactly as /stats always did.
* ``repro_serve_batches_total``, ``repro_serve_batched_launch_groups_total``,
  ``repro_serve_queue_depth`` (gauge), ``repro_serve_queue_depth_max``.

Mutation comes from the worker thread plus the submit path while the /stats
and /metrics HTTP threads read; every cell is an atomic counter, and queue
depth additionally serializes on ``_lock`` so ``queue_depth_max`` tracks the
true high-water mark.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from repro_torch.obs import MetricsRegistry

LATENCY_RING = 4096


def _percentiles(samples) -> dict:
    if not samples:
        return {"p50_ms": None, "p99_ms": None, "mean_ms": None}
    arr = np.asarray(samples, dtype=np.float64) * 1e3
    return {"p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
            "mean_ms": float(arr.mean())}


class TenantStats:
    """One tenant's serving counters — views over registry cells.

    ``requests`` is derived (completed + rejected_budget + failed): a request
    is *accepted* exactly when it resolves one way or the other, so the old
    separately-bumped field could only ever drift from the sum by a bug.
    """

    __slots__ = ("tenant", "_completed", "_rejected", "_failed", "_batched",
                 "_latency")

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tenant: str = "default"):
        registry = MetricsRegistry() if registry is None else registry
        self.tenant = tenant
        outcomes = registry.counter(
            "repro_serve_requests_total",
            "Resolved requests by outcome", labels=("tenant", "outcome"))
        self._completed = outcomes.labels(tenant=tenant, outcome="completed")
        self._rejected = outcomes.labels(tenant=tenant,
                                         outcome="rejected_budget")
        self._failed = outcomes.labels(tenant=tenant, outcome="failed")
        self._batched = registry.counter(
            "repro_serve_batched_requests_total",
            "Requests served inside a fused multi-request batch",
            labels=("tenant",)).labels(tenant=tenant)
        self._latency = registry.summary(
            "repro_serve_latency_seconds",
            "End-to-end request latency (bounded ring)",
            labels=("tenant",), maxlen=LATENCY_RING).labels(tenant=tenant)

    # -- outcome recording (atomic) -------------------------------------
    def record(self, outcome: str, batched: bool = False,
               latency_s: Optional[float] = None) -> None:
        """Resolve one request: outcome ∈ completed/rejected_budget/failed."""
        cell = {"completed": self._completed,
                "rejected_budget": self._rejected,
                "failed": self._failed}[outcome]
        cell.inc()
        if batched:
            self._batched.inc()
        if latency_s is not None:
            self._latency.observe(float(latency_s))

    def record_latency(self, seconds: float) -> None:
        self._latency.observe(float(seconds))

    # -- legacy field views ---------------------------------------------
    @property
    def requests(self) -> int:
        return self.completed + self.rejected_budget + self.failed

    @property
    def completed(self) -> int:
        return int(self._completed.value)

    @completed.setter
    def completed(self, v: int) -> None:
        self._completed.set(v)

    @property
    def rejected_budget(self) -> int:
        return int(self._rejected.value)

    @rejected_budget.setter
    def rejected_budget(self, v: int) -> None:
        self._rejected.set(v)

    @property
    def failed(self) -> int:
        return int(self._failed.value)

    @failed.setter
    def failed(self, v: int) -> None:
        self._failed.set(v)

    @property
    def batched_requests(self) -> int:
        return int(self._batched.value)

    @batched_requests.setter
    def batched_requests(self, v: int) -> None:
        self._batched.set(v)

    def to_dict(self) -> dict:
        d = {"requests": self.requests, "completed": self.completed,
             "rejected_budget": self.rejected_budget, "failed": self.failed,
             "batched_requests": self.batched_requests}
        d.update(_percentiles(self._latency.samples()))
        return d


class ServerStats:
    """Server-wide counters + per-tenant breakdown, registry-backed.

    ``batch_occupancy`` is the running mean number of requests per worker
    drain — the direct measure of how much cross-tenant fusion the traffic
    pattern allows (1.0 = purely sequential serving).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = MetricsRegistry() if registry is None else registry
        self._lock = threading.Lock()
        self.tenants: Dict[str, TenantStats] = {}      # guarded-by: _lock
        self._batches = self.registry.counter(
            "repro_serve_batches_total", "Worker queue drains")
        self._groups = self.registry.counter(
            "repro_serve_batched_launch_groups_total",
            "Fused signature groups launched across batches")
        self._depth = self.registry.gauge(
            "repro_serve_queue_depth", "Requests currently queued")
        self._depth_max = self.registry.gauge(
            "repro_serve_queue_depth_max", "Queue-depth high-water mark")

    # -- legacy field views ---------------------------------------------
    @property
    def batches(self) -> int:
        return int(self._batches.value)

    @property
    def batched_launch_groups(self) -> int:
        return int(self._groups.value)

    @property
    def queue_depth(self) -> int:
        return int(self._depth.value)

    @property
    def queue_depth_max(self) -> int:
        return int(self._depth_max.value)

    def tenant(self, tenant: str) -> TenantStats:
        with self._lock:
            ts = self.tenants.get(tenant)
            if ts is None:
                ts = self.tenants[tenant] = TenantStats(self.registry, tenant)
            return ts

    def enqueue(self) -> None:
        with self._lock:               # depth + max must move together
            d = self._depth.value + 1
            self._depth.set(d)
            self._depth_max.set_max(d)

    def dequeue(self, n: int) -> None:
        with self._lock:
            self._depth.set(max(0, self._depth.value - n))

    def record_batch(self, size: int, fused_groups: int = 0) -> None:
        self._batches.inc()
        if fused_groups:
            self._groups.inc(fused_groups)

    def to_dict(self, cache: Optional[object] = None,
                ledger: Optional[object] = None) -> dict:
        with self._lock:
            tenants = dict(self.tenants)
        total = sum(t.requests for t in tenants.values())
        batches = self.batches
        occ = (total / batches) if batches else 0.0
        d = {
            "requests_total": total,
            "batches": batches,
            "batch_occupancy": occ,
            "batched_launch_groups": self.batched_launch_groups,
            "queue_depth": self.queue_depth,
            "queue_depth_max": self.queue_depth_max,
            "tenants": {t: s.to_dict() for t, s in tenants.items()},
        }
        if cache is not None:
            lookups = cache.hits + cache.misses
            d["engine_cache"] = {
                "hits": cache.hits, "misses": cache.misses,
                "hit_rate": (cache.hits / lookups) if lookups else None,
                "entries": len(cache), "evictions": cache.evictions,
                "forced_evictions": cache.forced_evictions,
            }
        if ledger is not None:
            d["ledger"] = ledger.report()
        return d
