"""The port's observability layer (repro_torch.obs) against the JAX package's.

The behaviours of tests/test_obs.py, run on the port's copy: atomic cells,
families and their Prometheus text, the round-trip parser, the tracer's
falsy no-op when off, span trees, the JSONL sink; then the exposition text
of the two packages compared after the same operations, and the port's
engine, kernel and engine-cache stores mirrored into the four shared
families.
"""
import json
import threading

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.obs import (NOOP_SPAN, AtomicCounter, MetricsRegistry, Tracer,
                             exposition, parse_exposition)
from repro_torch.obs.naming import chain_label


def _threaded(fn, n_threads=8):
    ts = [threading.Thread(target=fn) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


# ------------------------------------------------------------- primitives
@pytest.mark.parametrize("kind", ["counter", "engine_stats", "chain_stats"])
def test_threaded_increments_are_atomic(kind):
    """AtomicCounter, EngineStats.bump and a ChainStats window under 8
    threads lose no increment."""
    from repro_torch.engine.engine import EngineStats
    from repro_torch.kernels.kron_matvec.stats import ChainStats
    per = 1000
    if kind == "counter":
        cell = AtomicCounter()
        bump, read = cell.inc, lambda: cell.value
    elif kind == "engine_stats":
        st = EngineStats()
        bump, read = (lambda: st.bump("measure_calls")), \
            (lambda: st.measure_calls)
    else:
        cs = ChainStats()
        bump, read = (lambda: cs.inc("fused_launches")), \
            (lambda: cs.fused_launches)

    def work():
        for _ in range(per):
            bump()

    _threaded(work)
    assert read() == 8 * per


def test_atomic_counter_set_max():
    c = AtomicCounter()
    c.set_max(5)
    c.set_max(3)
    assert c.value == 5


def test_counter_family_labels_and_render():
    reg = MetricsRegistry()
    fam = reg.counter("x_total", "things", labels=("kind",))
    fam.labels(kind="a").inc()
    fam.labels(kind="a").inc(2)
    fam.labels(kind="b").inc()
    text = fam.render()
    assert "# TYPE x_total counter" in text
    assert 'x_total{kind="a"} 3' in text
    assert 'x_total{kind="b"} 1' in text
    assert fam.labels(kind="a") is fam.labels(kind="a")


def test_unlabeled_family_proxies_implicit_child():
    reg = MetricsRegistry()
    g = reg.gauge("depth")
    g.set(4)
    g.set_max(2)
    assert g.value == 4
    with pytest.raises(ValueError, match="use .labels"):
        reg.counter("y_total", labels=("t",)).inc()


def test_histogram_cumulative_buckets():
    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", labels=(), buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.5, 5.0):
        h.observe(v)
    text = h.render()
    assert 'lat_seconds_bucket{le="0.1"} 1' in text
    assert 'lat_seconds_bucket{le="1"} 3' in text
    assert 'lat_seconds_bucket{le="+Inf"} 4' in text
    assert "lat_seconds_count 4" in text
    snap = h.labels().snapshot()
    assert snap["count"] == 4 and snap["sum"] == pytest.approx(6.05)


def test_summary_ring_bounded_and_quantiles():
    s = MetricsRegistry().summary("ring_seconds", maxlen=10).labels()
    for i in range(100):
        s.observe(float(i))
    assert s.samples() == [float(i) for i in range(90, 100)]
    assert s.count == 100
    assert s.quantile(0.5) in (94.0, 95.0)
    assert s.quantile(0.99) == 99.0


def test_registry_get_or_create_and_kind_mismatch():
    reg = MetricsRegistry()
    a = reg.counter("z_total", labels=("t",))
    assert reg.counter("z_total", labels=("t",)) is a
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("z_total", labels=("t",))
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("z_total", labels=("other",))


def test_exposition_merge_and_parse_roundtrip():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.counter("dup_total").inc(1)
    b.counter("dup_total").inc(99)
    b.counter("only_b_total", "help text", labels=("tenant",)).labels(
        tenant="t 0").inc(7)
    b.gauge("g").set(2.5)
    text = exposition(a, b)
    parsed = parse_exposition(text)
    assert parsed["dup_total"][""] == 1
    assert parsed["only_b_total"]['tenant="t 0"'] == 7
    assert parsed["g"][""] == 2.5
    assert text.count("# TYPE dup_total") == 1
    with pytest.raises(ValueError, match="malformed"):
        parse_exposition("no_value_here")
    assert b.sample_value("only_b_total", tenant="t 0") == 7
    assert b.sample_value("only_b_total", tenant="missing") is None
    assert b.sample_value("never_registered") is None


def _drive(pkg):
    """One sequence of registry operations, on either package's obs."""
    reg = pkg.MetricsRegistry()
    c = reg.counter("ops_total", "operations", labels=("op", "tenant"))
    c.labels(op="measure", tenant="a").inc(3)
    c.labels(op="reconstruct", tenant='q"uote\\').inc(0.5)
    reg.gauge("level", "a level").set(1e16)
    reg.gauge("frac").set(0.1 + 0.2)
    h = reg.histogram("lat_seconds", "latency", labels=("chain",),
                      buckets=(1e-4, 1e-3, 1e-2))
    for v in (5e-5, 2e-3, 0.5, 1e-3):
        h.labels(chain="5x5/b2/f32").observe(v)
    s = reg.summary("ring", "ring", maxlen=3, quantiles=(0.5, 0.9))
    for v in range(7):
        s.observe(float(v))
    reg.counter("inf_total").inc(float("inf"))
    other = pkg.MetricsRegistry()
    other.counter("ops_total", labels=("op", "tenant")).labels(
        op="x", tenant="y").inc()
    other.counter("extra_total").inc(2)
    return pkg.exposition(reg, other)


def test_exposition_text_equals_the_jax_packages():
    """The same operations render the same /metrics text in both packages
    (so one scrape reads alike whichever package serves it)."""
    assert _drive(tobs) == _drive(jobs)
    assert tobs.parse_exposition(_drive(tobs)) == \
        jobs.parse_exposition(_drive(jobs))


def test_chain_label_format():
    assert chain_label((5, 5, 5), 16, "float32") == "5x5x5/b16/f32"
    assert chain_label((), 4) == "scalar/b4/f32"
    assert chain_label((7,), 2, "bfloat16") == "7/b2/bf16"
    from repro.obs.naming import chain_label as jax_label
    for args in [((5, 5, 5), 16, "float32"), ((100, 100), 3, "float16")]:
        assert chain_label(*args) == jax_label(*args)


# ---------------------------------------------------------------- tracing
def test_tracer_off_returns_falsy_noop_singleton():
    tr = Tracer()
    sp = tr.span("anything")
    assert sp is NOOP_SPAN and not sp
    assert sp.set(a=1) is sp
    with sp:
        pass
    sp.end()
    if not tobs.TRACER.enabled:               # off unless REPRO_TRACE is set
        assert tobs.TRACER.span("x") is NOOP_SPAN


def test_span_tree_parents_via_context():
    tr = Tracer()
    tr.enable()
    try:
        with tr.span("root") as root, tr.span("child") as child:
            with tr.span("grandchild") as gc:
                pass
        spans = {s.name: s for s in tr.drain()}
        assert spans["child"].parent_id == root.span_id
        assert spans["grandchild"].parent_id == child.span_id
        assert {s.trace_id for s in spans.values()} == {root.trace_id}
        assert gc.t1 >= gc.t0
    finally:
        tr.disable()


def test_span_explicit_parent_t0_error_attrs_and_threads():
    tr = Tracer()
    tr.enable()
    try:
        root = tr.span("root")
        late = tr.span("backdated", parent=root, t0=root.t0 - 1.0)
        late.end()
        assert late.parent_id == root.span_id
        assert late.to_dict()["dur_us"] >= 1e6
        with pytest.raises(RuntimeError, match="boom"), tr.span("failing"):
            raise RuntimeError("boom")
        seen = {}

        def worker():
            with tr.activate(root), tr.span("in_thread") as sp:
                seen["parent"], seen["trace"] = sp.parent_id, sp.trace_id

        _threaded(worker, 1)
        root.end()
        assert seen == {"parent": root.span_id, "trace": root.trace_id}
        by_name = {s.name: s for s in tr.drain()}
        assert by_name["failing"].attrs["error"] == "RuntimeError"
        assert "boom" in by_name["failing"].attrs["error_msg"]
    finally:
        tr.disable()


def test_tracer_jsonl_sink_and_file_cap(tmp_path):
    path = tmp_path / "trace.jsonl"
    tr = Tracer()
    tr.enable(str(path), max_file_spans=3)
    try:
        for i in range(5):
            tr.span("s").set(i=i).end()
        tr.flush()
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert len(lines) == 3
        assert all(set(rec) >= {"trace", "span", "parent", "name", "t0",
                                "t1", "dur_us", "attrs"} for rec in lines)
        st = tr.stats()
        assert st["written"] == 3 and st["dropped"] == 2
        assert len(tr.drain()) == 5
    finally:
        tr.disable()


# ------------------------------------------------- the port's stores
def test_engine_stats_field_surface_and_mirror():
    from repro_torch.engine.engine import EngineStats
    st = EngineStats(measure_calls=2)
    assert st.measure_calls == 2 and st.to_dict()["measure_calls"] == 2
    st.measure_signatures = 7
    assert st.measure_signatures == 7
    with pytest.raises(TypeError):
        EngineStats(bogus=1)
    before = tobs.REGISTRY.sample_value("repro_engine_events_total",
                                        counter="synthesize_calls") or 0
    EngineStats().bump("synthesize_calls", 3)
    assert tobs.REGISTRY.sample_value(
        "repro_engine_events_total", counter="synthesize_calls") == before + 3


def test_chain_stats_reset_window_vs_monotone_mirror():
    from repro_torch.kernels.kron_matvec.stats import (CHAIN_STATS,
                                                       chain_stats,
                                                       reset_chain_stats)
    reset_chain_stats()
    before = tobs.REGISTRY.sample_value("repro_kernel_events_total",
                                        event="axis_launches") or 0
    CHAIN_STATS.inc("axis_launches", 2)
    assert chain_stats()["axis_launches"] == 2
    reset_chain_stats()
    assert chain_stats()["axis_launches"] == 0
    assert tobs.REGISTRY.sample_value("repro_kernel_events_total",
                                      event="axis_launches") == before + 2


def test_release_is_traced_and_metered(tmp_path):
    """One CPU release under tracing: engine spans with kernel.chain
    children, a release.postprocess span, the same tables as untraced, and
    the four shared families plus the roofline gauges in /metrics."""
    from repro_torch.core import Domain, all_kway, select_sum_of_variances
    from repro_torch.data.tabular import marginals_from_records, \
        synthetic_records
    from repro_torch.engine import MarginalEngine
    from repro_torch.engine.sharded import sharded_measure
    dom = Domain.create([3, 4, 5])
    plan = select_sum_of_variances(all_kway(dom, 2, include_lower=True), 1.0)
    recs = synthetic_records(dom, 300, seed=2)
    margs = marginals_from_records(dom, plan.cliques, recs)
    eng = MarginalEngine(plan, device="cpu")
    plain, _ = eng.release(margs, torch.Generator().manual_seed(5))
    path = tmp_path / "trace.jsonl"
    tobs.TRACER.enable(str(path))
    try:
        traced, _ = eng.release(margs, torch.Generator().manual_seed(5))
        eng.release(margs, torch.Generator().manual_seed(5),
                    postprocess="consistent", backend="host")
        sharded_measure(plan, recs, torch.Generator().manual_seed(5),
                        device="cpu")
    finally:
        tobs.TRACER.disable()
    for c in plain:
        assert np.array_equal(plain[c], traced[c]), c
    spans = [json.loads(ln) for ln in path.read_text().splitlines()]
    by_id = {s["span"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert {"engine.measure", "engine.reconstruct",
            "release.postprocess"} <= set(names)
    parents = {by_id[s["parent"]]["name"] for s in spans
               if s["name"] == "kernel.chain" and s["parent"] in by_id}
    assert {"engine.measure", "engine.reconstruct"} <= parents
    text = tobs.REGISTRY.exposition()
    for fam in ("repro_engine_events_total", "repro_kernel_events_total",
                "repro_engine_cache_events_total",
                "repro_kernel_launch_seconds", "repro_chain_smem_bytes",
                "repro_chain_predicted_seconds",
                "repro_chain_predicted_intensity"):
        assert f"# TYPE {fam} " in text, fam
    parsed = tobs.parse_exposition(text)
    lab = chain_label((3, 4), 1, "float32")
    assert parsed["repro_chain_smem_bytes"][f'chain="{lab}"'] > 0
