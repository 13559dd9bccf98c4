"""The idle share, the roofline share and the breakdown, on synthetic
profiler events."""
from __future__ import annotations

import pytest

from rpbench.harness import spec
from rpbench.harness.trace import (MARK, Trace, busy_seconds, idle_gaps,
                                   label_at, merged)


def obs(trace, releases=((0.0, 1.0), (1.0, 2.0)), window=(0.0, 2.0),
        least_s=0.1, spans=()):
    return spec.Observation(setup={"plan_s": 1.5}, setup_s=9.0,
                            releases=list(releases), cells=1000,
                            peak_bytes=2 ** 30, spans=list(spans), trace=trace,
                            window=window, least_s=least_s)


def read(name, o):
    return spec.load_module("metrics", name).read(o)


def test_union_clips_and_merges():
    iv = [(0.5, 2.0), (0.0, 1.0), (3.0, 4.0), (4.5, 9.0)]
    assert merged(iv, 0.0, 5.0) == [(0.0, 2.0), (3.0, 4.0), (4.5, 5.0)]
    assert busy_seconds(iv, 0.0, 5.0) == pytest.approx(3.5)
    assert idle_gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 4.5)]
    assert idle_gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_idle_share_counts_copies_as_busy():
    tr = Trace([("kernA", 0.0, 0.2), ("Memcpy HtoD (Pageable -> Device)", 0.1, 0.5),
                ("kernB", 1.5, 1.6)])
    assert read("device_idle_pct.release", obs(tr)) == pytest.approx(
        100 * (1 - 0.6 / 2.0))


def test_roofline_share_over_kernel_time_only():
    tr = Trace([("kernA", 0.0, 0.2), ("Memcpy DtoH (Device -> Pageable)", 0.2, 0.9),
                ("Memset (Device)", 0.9, 1.0), ("kernB", 1.5, 1.8)])
    # 2 releases x 0.1 s least over 0.5 s of kernels
    assert read("kernel_roofline_pct.release", obs(tr)) == pytest.approx(40.0)


def test_readers_return_nothing_without_a_trace():
    o = obs(None)
    assert read("kernel_roofline_pct.release", o) is None
    assert read("device_idle_pct.release", o) is None
    assert read("kernel_roofline_pct.release", obs(Trace([("Memcpy HtoD", 0, 1)]))) is None
    assert read("kernel_roofline_pct.release", obs(Trace([("k", 0, 1)]), least_s=None)) is None


def test_span_readers_divide_by_requests():
    spans = [("engine.measure", 0.1, 0.4), ("engine.measure", 1.1, 1.3),
             ("engine.reconstruct", 0.4, 0.9), ("engine.measure", 5.0, 6.0)]
    o = obs(None, spans=spans)
    assert read("measure_ms.release", o) == pytest.approx((0.3 + 0.2) / 2 * 1e3)
    assert read("reconstruct_ms.release", o) == pytest.approx(0.5 / 2 * 1e3)


def test_end_to_end_readers():
    o = obs(None, releases=[(0.0, 0.5), (0.5, 1.25), (1.25, 2.5)], window=(0.0, 2.0))
    assert read("release_cells_per_s", o) == pytest.approx(3 * 1000 / 2.5)
    assert read("release_p95_ms", o) == pytest.approx(1250.0)
    assert read("peak_device_gib", o) == 1.0
    assert read("setup_s", o) == 9.0
    assert read("plan_s", o) == 1.5


def test_breakdown_names_copies_and_labels_gaps():
    tr = Trace([("Memcpy HtoD (Pageable -> Device)", 0.0, 0.1),
                ("void fused_chain_kernel<float>(...)", 0.1, 0.2),
                ("Memcpy DtoH (Device -> Pageable)", 0.9, 1.0),
                ("Memcpy HtoD (Pageable -> Device)", 1.0, 1.05)])
    assert tr.top_ops()[0] == ["H2D", pytest.approx(0.15)]
    assert [n for n, _ in tr.top_ops()] == [
        "H2D", "void fused_chain_kernel<float>(...)", "D2H"]
    spans = [("engine.measure", 0.0, 0.95), ("kernel.chain", 0.05, 0.12),
             ("engine.reconstruct", 0.95, 1.5)]
    gaps = tr.top_gaps(0.0, 2.0, spans)
    assert gaps[0] == ["between releases", pytest.approx(0.95)]
    assert gaps[1] == ["engine.measure", pytest.approx(0.7)]
    assert label_at(0.1, spans) == "kernel.chain"


class _Ev:
    def __init__(self, name, start_ns, dur_ns, dev):
        self._n, self._s, self._d, self._dev = name, start_ns, dur_ns, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


class _Prof:
    def __init__(self, evs):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda s: evs})()


@pytest.mark.parametrize("marker", [(MARK, "DeviceType.CPU"),
                                    ("void at::cuda::spin_kernel(long)", "DeviceType.CUDA")])
def test_profiler_clock_shifted_by_the_marker(marker):
    evs = [_Ev("aten::mm", 5_100_000_000, 10, "DeviceType.CPU"),
           _Ev(marker[0], 5_000_000_000, 10, marker[1]),
           _Ev("kern", 5_500_000_000, 250_000_000, "DeviceType.CUDA")]
    tr = Trace.from_profiler(_Prof(evs), mark_mono_ns=2_000_000_000)
    assert tr.window(2.4, 3.0).ops == [("kern", pytest.approx(2.5), pytest.approx(2.75))]
    assert tr.window(2.8, 3.0).ops == []


def test_a_session_without_the_marker_is_refused():
    evs = [_Ev("kern", 7_000_000_000, 1_000_000_000, "DeviceType.CUDA")]
    with pytest.raises(RuntimeError):
        Trace.from_profiler(_Prof(evs), mark_mono_ns=0)
