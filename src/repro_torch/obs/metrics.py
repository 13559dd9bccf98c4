"""Typed metrics primitives + Prometheus text exposition (docs/OBSERVABILITY.md).

The port's copy of ``repro.obs.metrics``, unchanged in behaviour: the
exposition text of the two packages is equal after the same operations.

One :class:`MetricsRegistry` is the single backing store for every runtime
counter the system used to scatter across ad-hoc dataclasses: engine
``EngineStats``, kernel ``ChainStats``, engine-cache hit/eviction counters,
ledger charge/reject events, and the per-tenant latency rings.  The legacy
dataclass fields survive as thin views over registry-owned cells, so existing
call sites (``stats.measure_calls``, ``chain_stats()["pads"]``, ``/stats``)
keep working while ``/metrics`` renders the same values in Prometheus text
format — the two endpoints can never disagree because there is only one
store.

Primitives:

* :class:`AtomicCounter` — the raw lock-guarded cell every metric builds on.
  Also used standalone (unregistered) where per-instance counters must be
  race-free but aggregate elsewhere (``EngineStats``).
* :class:`Counter` / :class:`Gauge` — monotone events / settable levels.
* :class:`Histogram` — cumulative fixed buckets (+Inf implicit), sum, count.
* :class:`Summary` — a bounded latency ring (the former ``TenantStats``
  deque) rendered as quantile samples; p50/p99 are computed over the ring on
  demand, exactly as ``/stats`` always did.

All families are labeled; a family with no declared labels has one implicit
child.  Creation is idempotent per registry (get-or-create by name), and a
name re-registered with a different kind or label set raises — the exposition
must stay self-consistent.

Thread-safety: every mutable cell is guarded by its own lock, so metric
updates from the serve worker, the HTTP reader threads, and warmup paths
never race (the lock-discipline lint, docs/ANALYSIS.md LK001, polices the
annotations).
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Iterable, Optional, Sequence, Tuple


class AtomicCounter:
    """A lock-guarded numeric cell: the primitive under every metric."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: float = 0):
        self._lock = threading.Lock()
        self._value = value                      # guarded-by: _lock

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def set_max(self, v: float) -> None:
        """Atomically raise the cell to ``v`` if ``v`` is larger."""
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr."""
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(names: Sequence[str], values: Sequence[str],
                   extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _CounterChild(AtomicCounter):
    pass


class _GaugeChild(AtomicCounter):
    pass


class _HistogramChild:
    """Cumulative-bucket histogram cell (one label combination)."""

    def __init__(self, buckets: Sequence[float]):
        self._lock = threading.Lock()
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)   # guarded-by: _lock
        self._sum = 0.0                                # guarded-by: _lock
        self._count = 0                                # guarded-by: _lock

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            return {"buckets": self.buckets, "counts": counts,
                    "sum": self._sum, "count": self._count}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class _SummaryChild:
    """Bounded sample ring rendered as quantiles (the tenant latency ring).

    The ring is the registry-owned replacement for the per-tenant latency
    deque that used to live inside ``TenantStats``: O(1) memory for a
    long-lived server, exact percentiles over the most recent ``maxlen``
    observations.
    """

    def __init__(self, maxlen: int = 4096,
                 quantiles: Sequence[float] = (0.5, 0.99)):
        self._lock = threading.Lock()
        self.quantiles = tuple(quantiles)
        self._ring = deque(maxlen=maxlen)    # guarded-by: _lock
        self._sum = 0.0                      # guarded-by: _lock
        self._count = 0                      # guarded-by: _lock

    def observe(self, v: float) -> None:
        with self._lock:
            self._ring.append(float(v))
            self._sum += v
            self._count += 1

    def samples(self) -> list:
        with self._lock:
            return list(self._ring)

    def quantile(self, q: float) -> Optional[float]:
        vals = sorted(self.samples())
        if not vals:
            return None
        idx = min(len(vals) - 1, max(0, round(q * (len(vals) - 1))))
        return vals[idx]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


# Default histogram buckets: latency-flavored, in seconds.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class MetricFamily:
    """One named metric with a fixed label set and per-label-value children.

    A family with no declared labels proxies its single implicit child, so
    ``registry.counter("x").inc()`` works without a ``labels()`` hop.
    """

    def __init__(self, name: str, kind: str, help: str = "",
                 labels: Sequence[str] = (), **child_opts):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(labels)
        self._child_opts = child_opts
        self._lock = threading.Lock()
        self._children: Dict[tuple, object] = {}   # guarded-by: _lock

    def _make_child(self):
        if self.kind == "counter":
            return _CounterChild()
        if self.kind == "gauge":
            return _GaugeChild()
        if self.kind == "histogram":
            return _HistogramChild(
                self._child_opts.get("buckets") or DEFAULT_BUCKETS)
        if self.kind == "summary":
            return _SummaryChild(
                maxlen=self._child_opts.get("maxlen", 4096),
                quantiles=self._child_opts.get("quantiles", (0.5, 0.99)))
        raise ValueError(f"unknown metric kind {self.kind!r}")

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _implicit(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} declares labels {self.label_names}; "
                f"use .labels(...)")
        return self.labels()

    # -- no-label conveniences ------------------------------------------
    def inc(self, n: float = 1) -> None:
        self._implicit().inc(n)

    def set(self, v: float) -> None:
        self._implicit().set(v)

    def set_max(self, v: float) -> None:
        self._implicit().set_max(v)

    def observe(self, v: float) -> None:
        self._implicit().observe(v)

    @property
    def value(self):
        return self._implicit().value

    def children(self) -> Dict[tuple, object]:
        with self._lock:
            return dict(self._children)

    # ----------------------------------------------------------- render
    def render(self) -> str:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key, child in sorted(self.children().items()):
            lab = _render_labels(self.label_names, key)
            if self.kind in ("counter", "gauge"):
                lines.append(f"{self.name}{lab} {_fmt(child.value)}")
            elif self.kind == "histogram":
                snap = child.snapshot()
                acc = 0
                for le, n in zip(snap["buckets"], snap["counts"]):
                    acc += n
                    bl = _render_labels(self.label_names, key,
                                        extra=[("le", _fmt(le))])
                    lines.append(f"{self.name}_bucket{bl} {acc}")
                acc += snap["counts"][-1]
                bl = _render_labels(self.label_names, key,
                                    extra=[("le", "+Inf")])
                lines.append(f"{self.name}_bucket{bl} {acc}")
                lines.append(f"{self.name}_sum{lab} {_fmt(snap['sum'])}")
                lines.append(f"{self.name}_count{lab} {snap['count']}")
            elif self.kind == "summary":
                for q in child.quantiles:
                    v = child.quantile(q)
                    if v is None:
                        continue
                    ql = _render_labels(self.label_names, key,
                                        extra=[("quantile", _fmt(q))])
                    lines.append(f"{self.name}{ql} {_fmt(v)}")
                lines.append(f"{self.name}_sum{lab} {_fmt(child.sum)}")
                lines.append(f"{self.name}_count{lab} {child.count}")
        return "\n".join(lines)


class MetricsRegistry:
    """Get-or-create registry of :class:`MetricFamily` by name.

    The process-global :data:`REGISTRY` backs process-wide stores (kernel
    chain counters, engine aggregates, autotune decisions); each
    release server (the JAX package's ``ReleaseServer``) additionally owns a private
    registry for its tenant-scoped series so two servers in one process (or
    one test run) never cross-pollute.  ``/metrics`` renders the server
    registry merged with the global one (:func:`exposition`).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}   # guarded-by: _lock

    def _family(self, name: str, kind: str, help: str,
                labels: Sequence[str], **child_opts) -> MetricFamily:
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = MetricFamily(
                    name, kind, help, labels, **child_opts)
            elif fam.kind != kind or fam.label_names != labels:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind} "
                    f"with labels {fam.label_names}; cannot re-register as "
                    f"{kind} with labels {labels}")
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        return self._family(name, "histogram", help, labels, buckets=buckets)

    def summary(self, name: str, help: str = "",
                labels: Sequence[str] = (), maxlen: int = 4096,
                quantiles: Sequence[float] = (0.5, 0.99)) -> MetricFamily:
        return self._family(name, "summary", help, labels, maxlen=maxlen,
                            quantiles=quantiles)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def collect(self) -> list:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def sample_value(self, name: str, **labels):
        """Test/debug convenience: current value of one counter/gauge child."""
        fam = self.get(name)
        if fam is None:
            return None
        key = tuple(str(labels[n]) for n in fam.label_names)
        child = fam.children().get(key)
        return None if child is None else child.value

    def exposition(self) -> str:
        return exposition(self)


def exposition(*registries: MetricsRegistry) -> str:
    """Prometheus text format (version 0.0.4) over one or more registries.

    Later registries skip families whose name an earlier registry already
    rendered, so merging a server registry with the global registry can never
    emit a duplicate ``# TYPE``.
    """
    seen: set = set()
    chunks = []
    for reg in registries:
        for fam in reg.collect():
            if fam.name in seen:
                continue
            seen.add(fam.name)
            chunks.append(fam.render())
    body = "\n".join(c for c in chunks if c)
    return body + "\n" if body else ""


def parse_exposition(text: str) -> Dict[str, Dict[str, float]]:
    """Tiny exposition parser (tests): {metric_name: {label_str: value}}.

    Accepts exactly what :func:`exposition` emits; raises on malformed
    sample lines so tests can assert the endpoint stays parseable.
    """
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_part, _, value = line.rpartition(" ")
        if not name_part:
            raise ValueError(f"malformed sample line: {line!r}")
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            if not rest.endswith("}"):
                raise ValueError(f"malformed labels: {line!r}")
            labels = rest[:-1]
        else:
            name, labels = name_part, ""
        v = float(value)
        out.setdefault(name, {})[labels] = v
    return out


# Process-global default registry (kernel counters, engine aggregates).
REGISTRY = MetricsRegistry()


def label_values(fam: MetricFamily) -> Iterable[tuple]:
    return fam.children().keys()
