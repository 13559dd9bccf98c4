"""Observability: metrics registry + request-scoped tracing.

The port's own copy of the JAX package's ``repro.obs`` (standard library
only, so every layer — engine, kernels, release — can depend on it without
cycles, and the port imports nothing of the JAX package).  The family names
are the JAX package's (``repro_engine_events_total``,
``repro_kernel_events_total``, ``repro_engine_cache_events_total``), so one
``/metrics`` scrape reads the same whichever package serves it; the port
has no ``repro_kernel_launch_seconds`` (its ``kernel.chain`` span times a
chain call's host dispatch when tracing is on).  ``REPRO_TRACE`` selects
the same JSONL sink.
See docs/OBSERVABILITY.md for the span model and metric naming.
"""
from .metrics import (
    REGISTRY,
    AtomicCounter,
    MetricFamily,
    MetricsRegistry,
    exposition,
    parse_exposition,
)
from .trace import NOOP_SPAN, TRACER, Span, Tracer

__all__ = [
    "AtomicCounter",
    "MetricFamily",
    "MetricsRegistry",
    "REGISTRY",
    "exposition",
    "parse_exposition",
    "Span",
    "Tracer",
    "TRACER",
    "NOOP_SPAN",
]
