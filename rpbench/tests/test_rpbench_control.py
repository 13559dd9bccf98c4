"""The controls come out not correct, and so does a run whose timed path is
broken underneath: a release that returns an earlier answer, noise that
is not the release's own, half of a group left out and the mean of the
rest put in its place, an answer altered where it is produced, and a
release that raises.  (One card: there is no exchange between chips to
leave out.)"""
from __future__ import annotations

import numpy as np
import pytest
import torch


def run(bench, cell, **kw):
    res, lines = bench.run_cell(cell, 2 ** 32 + 17, 0.3, False, device="cpu",
                                log=lambda m: None, **kw)
    failing = {ln.split()[1] for ln in lines if ln.endswith("FAILED")}
    return res, failing


def test_sound_run_is_correct(bench, tiny_cell):
    res, failing = run(bench, tiny_cell())
    assert res["correct"] and not failing


@pytest.mark.parametrize("name,fails", [
    ("program-bf16", {"table_rel"}),
    ("reference-lower", {"sigma2_rel", "omega_rel", "table_rel"})])
def test_controls_are_not_correct(bench, tiny_cell, name, fails):
    from rpbench import control
    res, lines = control.run_control(tiny_cell(), name, 2 ** 32 + 17, 0.3,
                                     device="cpu")
    assert not res["correct"]
    assert {ln.split()[1] for ln in lines if ln.endswith("FAILED")} == fails


class Faulty:
    """The program's engine with one fault planted in what it returns."""

    def __init__(self, engine, fault):
        self.engine, self.fault, self.first, self.calls = engine, fault, None, 0

    def release(self, margs, gen):
        self.calls += 1
        if self.fault == "raise" and self.calls > 1:      # after the warm-up
            raise RuntimeError("planted failure")
        if self.fault == "noise":
            gen = torch.Generator().manual_seed(1)
        tables, meas = self.engine.release(margs, gen)
        if self.fault == "stale":
            if self.first is None:
                self.first = (tables, meas)
            return self.first
        if self.fault == "half":
            sizes = self.engine.plan.domain.sizes
            groups = {}
            for c in tables:
                groups.setdefault(tuple(sizes[i] for i in c), []).append(c)
            group = max(groups.values(), key=len)
            keep, drop = group[: len(group) // 2], group[len(group) // 2:]
            mean = np.mean([tables[c] for c in keep], axis=0)
            tables = {**tables, **{c: mean for c in drop}}
        if self.fault == "altered":
            c = max(tables, key=len)
            t = np.array(tables[c], copy=True)
            i = int(np.argmax(np.abs(t)))
            t[i] = -t[i]
            tables = dict(tables)
            tables[c] = t
        return tables, meas


@pytest.mark.parametrize("fault", ["stale", "noise", "half", "altered", "raise"])
def test_planted_faults_are_not_correct(bench, tiny_cell, fault):
    def factory(plan, device):
        return Faulty(bench.program_engine(plan, device), fault)
    res, failing = run(bench, tiny_cell(), engine_factory=factory)
    assert not res["correct"]
    if fault == "raise":
        assert res["failed"] == res["attempted"] > 0
    else:
        assert "table_rel" in failing
