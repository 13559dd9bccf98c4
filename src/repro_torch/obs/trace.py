"""Request-scoped tracing: context-manager spans, contextvar propagation,
a bounded in-memory ring, and an fsync-free JSONL sink.

The port's copy of ``repro.obs.trace``; the same span schema and the same
``REPRO_TRACE`` switch.  The port's spans time host work: a span around a
kernel launch ends when the launch is queued, not when the card finishes.

Model (docs/OBSERVABILITY.md):

* A **span** is one timed operation: name, monotonic start/end, attributes,
  a span ID, a trace ID shared by every span of one request, and a parent
  span ID linking the tree together.
* The **current span** rides a :mod:`contextvars` variable, so nested
  ``with tracer.span(...)`` calls parent automatically.  Crossing a thread
  boundary (serve worker picking up a queued request) is explicit:
  :meth:`Tracer.activate` re-installs a span as the ambient parent inside
  the worker.
* **Zero-cost-when-off**: ``Tracer.span()`` checks one attribute and returns
  a shared no-op singleton when tracing is disabled — no allocation, no
  clock read, no lock.  The no-op span is falsy so call sites can guard
  optional attribute work with ``if sp:``.  The serve-bench overhead gate
  (≤2% disabled) holds the fast path to that contract.
* **Sink**: finished spans land in a bounded ring (``deque(maxlen=...)``)
  and, when a path is configured (``REPRO_TRACE=/path`` or
  ``enable(path=...)``), are appended as one JSON object per line.  Writes
  are buffered and never fsynced — tracing must not serialize the worker on
  disk latency — and a hard cap on spans-per-file guards against unbounded
  logs from a long-lived server; overflow increments a ``dropped`` counter
  instead of writing.  A span the full ring pushes out before anyone
  drained it increments ``evicted``; :meth:`Tracer.totals` keeps each
  name's count and seconds since ``enable()`` whatever the ring lost.
* **IDs** are 16 hex characters, as the JAX package's, but minted from a
  counter that starts at a random 63-bit point in each process (re-drawn in
  a forked child), not from ``os.urandom`` per span: unique within a
  process, and two processes' IDs overlap only if their starts fall within
  one run's span count of each other.

Span JSON schema (one line each)::

    {"trace": "8f3c...", "span": "02ab...", "parent": "f1d0..." | null,
     "name": "serve.request", "t0": 1234.5678, "t1": 1234.5690,
     "dur_us": 1200.0, "attrs": {...}}

``t0``/``t1`` are *monotonic* seconds (durations are exact; absolute wall
time is not recorded).  ``tools/repro_trace.py`` consumes this format.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Optional

_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_span", default=None)

# Hard cap on spans written to one JSONL sink file (ring keeps the newest
# spans in memory regardless; the file cap bounds disk growth only).
MAX_FILE_SPANS = 200_000


def _id_counter() -> "itertools.count":
    return itertools.count(int.from_bytes(os.urandom(8), "big") >> 1)


_IDS = _id_counter()


def _reseed_ids() -> None:
    global _IDS
    _IDS = _id_counter()


os.register_at_fork(after_in_child=_reseed_ids)


def _new_id() -> str:
    return "%016x" % next(_IDS)


class _NoopSpan:
    """Shared do-nothing span returned when tracing is off.

    Falsy, so ``if sp: sp.set(...)`` skips attribute building entirely.
    """

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def end(self) -> None:
        pass

    @property
    def trace_id(self) -> None:
        return None

    @property
    def span_id(self) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed operation in a trace tree.

    Use as a context manager (normal case) or call :meth:`end` explicitly
    (root spans that outlive the scope that minted them, e.g. the
    ``serve.request`` span created in ``submit()`` and ended by the worker).
    """

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "t0", "t1", "attrs", "_token", "_ended")

    def __init__(self, tracer: "Tracer", name: str,
                 trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 t0: Optional[float] = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id or _new_id()
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.t0 = time.monotonic() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs: dict = {}
        self._token = None
        self._ended = False

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._token = _CTX.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
            if exc is not None:
                self.attrs["error_msg"] = str(exc)[:200]
        self.end()
        return False

    def end(self, t1: Optional[float] = None) -> None:
        if self._ended:
            return
        self._ended = True
        self.t1 = time.monotonic() if t1 is None else t1
        self.tracer._record(self)

    def to_dict(self) -> dict:
        t1 = self.t1 if self.t1 is not None else self.t0
        return {
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "t0": self.t0,
            "t1": t1,
            "dur_us": (t1 - self.t0) * 1e6,
            "attrs": self.attrs,
        }


class Tracer:
    """Span factory + sink.  One process-global instance (:data:`TRACER`).

    ``enabled`` is the single fast-path check: when False, :meth:`span`
    returns :data:`NOOP_SPAN` immediately.
    """

    def __init__(self, ring_size: int = 4096):
        self.enabled = False
        self._lock = threading.Lock()
        self._ring = deque(maxlen=ring_size)   # guarded-by: _lock
        self._fh = None                        # guarded-by: _lock
        self._path: Optional[str] = None       # guarded-by: _lock
        self._written = 0                      # guarded-by: _lock
        self._dropped = 0                      # guarded-by: _lock
        self._evicted = 0                      # guarded-by: _lock
        self._totals: dict = {}                # guarded-by: _lock

    # ------------------------------------------------------------ control
    def enable(self, path: Optional[str] = None,
               max_file_spans: int = MAX_FILE_SPANS) -> None:
        """Turn tracing on, optionally appending spans to ``path`` (JSONL)."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            self._path = path
            self._written = 0
            self._dropped = 0
            self._evicted = 0
            self._totals = {}
            self._max_file_spans = max_file_spans
            if path:
                self._fh = open(path, "a", encoding="utf-8")  # noqa: SIM115
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
            self._path = None

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    # ------------------------------------------------------------ factory
    def span(self, name: str, *, trace_id: Optional[str] = None,
             parent: Optional[Span] = None,
             t0: Optional[float] = None):
        """Create a span, or the no-op singleton when tracing is off.

        Parent resolution: explicit ``parent`` arg wins, else the ambient
        context span; trace ID inherits from the parent unless given.
        ``t0`` backdates the start (cross-thread queue-wait spans measure
        an interval that began before the span object could exist).
        """
        if not self.enabled:
            return NOOP_SPAN
        if parent is None:
            parent = _CTX.get()
        if isinstance(parent, _NoopSpan):
            parent = None
        pid = parent.span_id if parent is not None else None
        if trace_id is None and parent is not None:
            trace_id = parent.trace_id
        return Span(self, name, trace_id=trace_id, parent_id=pid, t0=t0)

    @contextlib.contextmanager
    def activate(self, span):
        """Install ``span`` as the ambient parent for this thread/context.

        Used at thread boundaries: the serve worker re-activates the root
        span minted by ``submit()`` so engine/kernel spans parent correctly.
        A falsy (no-op) span deactivates any inherited context instead.
        """
        token = _CTX.set(span if span else None)
        try:
            yield span
        finally:
            _CTX.reset(token)

    def current(self):
        return _CTX.get()

    # ------------------------------------------------------------- sink
    def _record(self, span: Span) -> None:
        line = None
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._evicted += 1
            self._ring.append(span)
            tot = self._totals.get(span.name)
            if tot is None:
                tot = self._totals[span.name] = [0, 0.0]
            tot[0] += 1
            tot[1] += span.t1 - span.t0
            if self._fh is not None:
                if self._written < getattr(self, "_max_file_spans",
                                           MAX_FILE_SPANS):
                    self._written += 1
                    line = json.dumps(span.to_dict(), separators=(",", ":"))
                else:
                    self._dropped += 1
            if line is not None:
                self._fh.write(line + "\n")

    def drain(self) -> list:
        """Return and clear the in-memory ring (tests, ad-hoc inspection)."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
            return out

    def totals(self) -> dict:
        """{span name: (spans, seconds)} of every span finished since the
        last :meth:`enable`, evicted from the ring or drained or not."""
        with self._lock:
            return {k: (v[0], v[1]) for k, v in self._totals.items()}

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "path": self._path,
                    "written": self._written, "dropped": self._dropped,
                    "evicted": self._evicted, "ring": len(self._ring)}


TRACER = Tracer()

# REPRO_TRACE=/path/to/trace.jsonl activates tracing at import time;
# REPRO_TRACE=1 enables the in-memory ring without a file sink.
_env = os.environ.get("REPRO_TRACE")
if _env:
    TRACER.enable(None if _env in ("1", "true", "ring") else _env)
