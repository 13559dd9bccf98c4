"""The five phase readers, on a synthetic Observation and the program's
tracer totals; then through a traced run of the tiny cell on the CPU."""
from __future__ import annotations

import pytest

from rpbench.harness import spec

READERS = {
    "prep_ms.release": ("measure.prep", "reconstruct.prep"),
    "stage_ms.release": ("measure.stack", "reconstruct.embed"),
    "copy_ms.release": ("measure.h2d", "measure.d2h", "reconstruct.h2d",
                        "reconstruct.d2h"),
    "dispatch_ms.release": ("kernel.chain",),
    "unpack_ms.release": ("measure.scatter", "reconstruct.slice"),
}


def obs(n_releases):
    return spec.Observation(setup={}, setup_s=1.0,
                            releases=[(float(i), i + 1.0)
                                      for i in range(n_releases)],
                            cells=10, peak_bytes=None, spans=[], trace=None,
                            window=(0.0, float(n_releases)), least_s=None)


def read(name, o):
    return spec.load_module("metrics", name).read(o)


@pytest.fixture
def tracer(bench):
    from repro_torch.obs import TRACER
    TRACER.enable()
    yield TRACER
    TRACER.disable()
    TRACER.drain()


def _spans(tracer, names, seconds):
    for name in names:
        sp = tracer.span(name, t0=100.0)
        sp.end(100.0 + seconds)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_phase_reader_sums_its_spans_per_request(tracer, metric):
    """Each reader sums its own span names (two of each here, 5 ms a span)
    over the requests completed, and ignores every other name."""
    names = READERS[metric]
    _spans(tracer, names * 2, 0.005)
    _spans(tracer, ("engine.measure", "serve.batch"), 1.0)
    others = {n for ns in READERS.values() for n in ns} - set(names)
    _spans(tracer, sorted(others), 0.5)
    tracer.disable()
    assert read(metric, obs(4)) == pytest.approx(len(names) * 2 * 5.0 / 4)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_phase_reader_reads_nothing_without_spans(tracer, metric,
                                                  monkeypatch):
    """No such span, no request, or a program whose tracer keeps no
    totals (the parent of this change): None, never an exception."""
    assert read(metric, obs(3)) is None
    _spans(tracer, READERS[metric], 0.01)
    assert read(metric, obs(0)) is None
    assert read(metric, obs(3)) == pytest.approx(
        len(READERS[metric]) * 10.0 / 3)
    import repro_torch.obs as tobs
    monkeypatch.setattr(tobs, "TRACER", object())
    assert read(metric, obs(3)) is None


def test_enable_starts_the_totals_afresh(tracer):
    _spans(tracer, ["kernel.chain"], 1.0)
    tracer.enable()
    _spans(tracer, ["kernel.chain"], 0.002)
    assert read("dispatch_ms.release", obs(1)) == pytest.approx(2.0)


def test_traced_tiny_run_reports_the_phases(bench, tiny_cell):
    """A traced CPU run of the tiny cell reports all five, and they cover
    most of the measure and reconstruct spans without exceeding them."""
    res, _ = bench.run_cell(tiny_cell("release"), 2 ** 35 + 11, 0.6, True,
                            device="cpu", log=lambda m: None)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(m)
    phases = sum(m[k] for k in READERS)
    whole = m["measure_ms.release"] + m["reconstruct_ms.release"]
    assert all(m[k] > 0 for k in READERS)
    assert 0.5 * whole < phases <= whole
