"""The port's durable budget ledger (repro_torch.serve.ledger).

A counterpart of every test in tests/test_ledger.py, on the port's ledger,
plus the journal format across the two packages: a journal written by either
package's ledger replays in the other to the same spend.

The serving tier's privacy invariant is that the journal can never
*under*-state a tenant's spend relative to what was measured: every
measurement is preceded by a durable charge record (charge-before-measure),
so replay after a crash restores at least the spend of every measurement
that could have produced output.
"""
import json
import os
import tempfile
import threading

import pytest

from _hypothesis_compat import given, settings, st

from repro_torch.core.accountant import BudgetExhausted
from repro_torch.serve.ledger import (BudgetLedger, LedgerCorrupt,
                                      LedgerFailed, UnknownTenant)


def _path(tmp_path, name="ledger.jsonl"):
    return os.path.join(str(tmp_path), name)


def test_register_charge_report(tmp_path):
    led = BudgetLedger(_path(tmp_path))
    led.register("acme", rho=0.5)             # pcost_total = 1.0
    led.charge("acme", 0.25, request_id="r1")
    led.charge("acme", 0.25)
    assert led.spent("acme") == pytest.approx(0.5)
    assert led.remaining("acme") == pytest.approx(0.5)
    assert led.remaining_rho("acme") == pytest.approx(0.25)
    rep = led.report("acme")
    assert rep["charges"] == 2
    assert rep["rho_zcdp"] == pytest.approx(0.25)
    assert set(led.report()) == {"acme"}
    led.close()


def test_register_validation(tmp_path):
    led = BudgetLedger(_path(tmp_path))
    with pytest.raises(ValueError):
        led.register("t", rho=1.0, pcost=1.0)      # both
    with pytest.raises(ValueError):
        led.register("t")                          # neither
    with pytest.raises(ValueError):
        led.register("t", rho=-1.0)
    with pytest.raises(UnknownTenant):
        led.charge("ghost", 0.1)
    with pytest.raises(UnknownTenant):
        led.remaining("ghost")
    led.close()


def test_over_budget_carries_exact_remaining_rho(tmp_path):
    led = BudgetLedger(_path(tmp_path))
    led.register("t", rho=0.5)
    led.charge("t", 0.75)
    with pytest.raises(BudgetExhausted) as ei:
        led.charge("t", 0.5)
    err = ei.value
    assert err.tenant == "t"
    assert err.requested_pcost == pytest.approx(0.5)
    assert err.remaining_pcost == pytest.approx(0.25)
    assert err.remaining_rho == pytest.approx(0.125)   # exact remaining ρ
    assert "0.125" in str(err)                         # ... and in the message
    # the rejected charge was NOT journaled and NOT applied
    assert led.spent("t") == pytest.approx(0.75)
    led.close()
    assert BudgetLedger(_path(tmp_path)).spent("t") == pytest.approx(0.75)


def test_replay_restores_spend(tmp_path):
    p = _path(tmp_path)
    with BudgetLedger(p) as led:
        led.register("a", rho=2.0)
        led.register("b", pcost=1.0)
        led.charge("a", 0.5)
        led.charge("b", 0.25)
        led.charge("a", 0.125)
    led2 = BudgetLedger(p)
    assert led2.replayed_records == 5
    assert led2.spent("a") == pytest.approx(0.625)
    assert led2.spent("b") == pytest.approx(0.25)
    # budgets still enforced after replay
    with pytest.raises(BudgetExhausted):
        led2.charge("b", 0.80)
    led2.close()


def test_crash_between_journal_and_memory_never_undercharges(tmp_path):
    """A charge that reached the journal counts after replay even if the
    in-memory apply (and the measurement) never happened."""
    p = _path(tmp_path)
    led = BudgetLedger(p)
    led.register("t", pcost=10.0)
    led.charge("t", 1.0)
    # simulate the crash window: journal append succeeded, process died
    # before the in-memory budget advanced / the measurement ran
    led._append({"op": "charge", "tenant": "t", "pcost": 2.0,
                 "request_id": "crashed"})
    led.close()
    led2 = BudgetLedger(p)
    assert led2.spent("t") == pytest.approx(3.0)   # ≥ every measured charge
    led2.close()


def test_replay_tolerates_trailing_partial_line_only(tmp_path):
    p = _path(tmp_path)
    with BudgetLedger(p) as led:
        led.register("t", pcost=4.0)
        led.charge("t", 1.0)
    with open(p, "a") as fh:                      # crash mid-append
        fh.write('{"op": "charge", "tenant": "t", "pc')
    led2 = BudgetLedger(p)
    assert led2.spent("t") == pytest.approx(1.0)  # tail dropped, rest intact
    led2.close()

    # ... but corruption FOLLOWED by more records refuses to serve
    with open(p, "w") as fh:
        fh.write('{"op": "register", "tenant": "t", "pcost_total": 4.0}\n')
        fh.write("GARBAGE\n")
        fh.write('{"op": "charge", "tenant": "t", "pcost": 1.0}\n')
    with pytest.raises(LedgerCorrupt):
        BudgetLedger(p)


def test_charge_for_unregistered_tenant_in_journal_is_corruption(tmp_path):
    p = _path(tmp_path)
    with open(p, "w") as fh:
        fh.write('{"op": "charge", "tenant": "ghost", "pcost": 1.0}\n')
    with pytest.raises(LedgerCorrupt):
        BudgetLedger(p)


def test_reregister_keeps_spend(tmp_path):
    led = BudgetLedger(_path(tmp_path))
    led.register("t", pcost=1.0)
    led.charge("t", 0.75)
    led.register("t", pcost=2.0)                  # top-up
    assert led.spent("t") == pytest.approx(0.75)
    assert led.remaining("t") == pytest.approx(1.25)
    led.register("t", pcost=0.5)                  # shrink below spend
    assert led.remaining("t") == 0.0
    with pytest.raises(BudgetExhausted):
        led.charge("t", 0.1)
    led.close()


class _FlakyFH:
    """Wraps the ledger's raw journal handle; fails the next write partway
    through (half the bytes land, then OSError — the ENOSPC shape)."""

    def __init__(self, fh):
        self._fh = fh
        self.fail_next = False

    def write(self, data):
        if self.fail_next:
            self.fail_next = False
            self._fh.write(data[: len(data) // 2])
            raise OSError(28, "No space left on device")
        return self._fh.write(data)

    def __getattr__(self, name):
        return getattr(self._fh, name)


def test_failed_append_truncates_partial_record(tmp_path):
    """A mid-record write failure rolls the file back to the pre-write
    length: no partial line is left to become non-trailing corruption, the
    in-memory budget never advanced, and both retry and replay work."""
    p = _path(tmp_path)
    led = BudgetLedger(p)
    led.register("t", pcost=4.0)
    led.charge("t", 1.0)
    flaky = _FlakyFH(led._fh)
    led._fh = flaky
    flaky.fail_next = True
    with pytest.raises(OSError):
        led.charge("t", 1.0)
    assert led.spent("t") == pytest.approx(1.0)   # memory did not advance
    # the journal holds only complete lines — a restart replays cleanly
    # (before the truncate fix this was the LedgerCorrupt availability loss)
    with open(p) as fh:
        recs = [json.loads(ln) for ln in fh if ln.strip()]
    assert sum(1 for r in recs if r["op"] == "charge") == 1
    led.charge("t", 1.0)                          # handle still usable
    assert led.spent("t") == pytest.approx(2.0)
    led.close()
    led2 = BudgetLedger(p)
    assert led2.spent("t") == pytest.approx(2.0)
    led2.close()


def test_unrollable_append_failure_marks_ledger_failed(tmp_path, monkeypatch):
    """If the rollback truncate ALSO fails, the on-disk tail is unknown:
    the ledger refuses every further charge instead of appending after a
    possible partial record."""
    led = BudgetLedger(_path(tmp_path))
    led.register("t", pcost=4.0)
    flaky = _FlakyFH(led._fh)
    led._fh = flaky
    flaky.fail_next = True
    monkeypatch.setattr(os, "ftruncate",
                        lambda fd, n: (_ for _ in ()).throw(OSError(5, "io")))
    with pytest.raises(OSError):
        led.charge("t", 1.0)
    monkeypatch.undo()
    assert led.spent("t") == 0.0
    with pytest.raises(LedgerFailed):
        led.charge("t", 1.0)
    assert led.spent("t") == 0.0                  # still nothing applied
    led.close()


def test_concurrent_tenant_charge_race(tmp_path):
    """32 threads fight over a budget that admits exactly 10 unit charges:
    exactly 10 succeed, the journal agrees, and replay agrees."""
    p = _path(tmp_path)
    led = BudgetLedger(p, fsync=False)
    led.register("t", pcost=10.0)
    led.register("u", pcost=5.0)
    wins, losses = [], []
    barrier = threading.Barrier(32)

    def worker(i):
        barrier.wait()
        for _ in range(4):
            try:
                led.charge("t" if i % 2 else "u", 1.0, request_id=f"w{i}")
            except BudgetExhausted:
                losses.append(i)
            else:
                wins.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(wins) == 15                        # 10 on "t" + 5 on "u"
    assert led.spent("t") == pytest.approx(10.0)
    assert led.spent("u") == pytest.approx(5.0)
    led.close()
    with open(p) as fh:
        recs = [json.loads(ln) for ln in fh if ln.strip()]
    assert sum(1 for r in recs if r["op"] == "charge") == 15
    led2 = BudgetLedger(p)
    assert led2.spent("t") == pytest.approx(10.0)
    assert led2.spent("u") == pytest.approx(5.0)
    led2.close()


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.floats(min_value=0.01, max_value=2.0),
                          st.integers(min_value=0, max_value=1)),
                min_size=1, max_size=12))
def test_crash_recovery_property_never_undercharges(charges):
    """Kill the process at ANY point between journal-append and memory-apply:
    the replayed spend is >= the sum of every charge whose measurement could
    have run (i.e. every charge() that returned + every journaled crash).

    No pytest fixtures here: the hypothesis-compat fallback hides the test
    signature from fixture resolution, so the temp dir is made by hand."""
    tmp = tempfile.mkdtemp(prefix="torch_ledger_prop_")
    p = os.path.join(tmp, "j.jsonl")
    led = BudgetLedger(p, fsync=False)
    led.register("t", pcost=1e6)
    measured = 0.0           # spend of charges a measurement could follow
    for pcost, crash_here in charges:
        if crash_here:
            # journal reached disk; process dies before memory apply
            led._append({"op": "charge", "tenant": "t", "pcost": pcost})
            measured += 0.0  # measurement never ran — still must be charged
            break
        led.charge("t", pcost)
        measured += pcost
    led.close()
    led2 = BudgetLedger(p)
    assert led2.spent("t") >= measured - 1e-9
    led2.close()


# ------------------------------------------------------- across the packages
def _journal_traffic(mod, exhausted, path):
    """The same register/charge/re-register/reject traffic on a ledger of
    the package module ``mod`` (``exhausted``: its BudgetExhausted)."""
    with mod.BudgetLedger(path, fsync=False) as led:
        led.register("a", rho=2.0)
        led.register("b", pcost=1.0)
        for pc in (0.5, 0.125, 0.1 + 0.2, 1e-7):
            led.charge("a", pc, request_id=f"a{pc}")
        led.charge("b", 0.75)
        led.register("b", pcost=0.9)               # shrink: keep the spend
        with pytest.raises(exhausted):
            led.charge("b", 0.5)


def _state(led):
    return {t: (led.spent(t), led.remaining(t), led.report(t)["charges"])
            for t in led.tenants}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_replays_across_packages(tmp_path, writer):
    """A journal written by one package's ledger replays in the other's to
    the same spend, remaining budget and charge count per tenant, exactly."""
    import repro.serve.ledger as jax_ledger
    from repro.core.accountant import BudgetExhausted as JaxExhausted
    import repro_torch.serve.ledger as torch_ledger
    mods = {"jax": (jax_ledger, JaxExhausted),
            "torch": (torch_ledger, BudgetExhausted)}
    wmod, exhausted = mods[writer]
    rmod = mods["torch" if writer == "jax" else "jax"][0]
    p = _path(tmp_path)
    _journal_traffic(wmod, exhausted, p)
    written = wmod.BudgetLedger(p)
    want = _state(written)
    written.close()
    replayed = rmod.BudgetLedger(p)
    assert replayed.replayed_records == 8
    assert _state(replayed) == want                # floats equal, not approx
    assert want["a"][0] == 0.5 + 0.125 + (0.1 + 0.2) + 1e-7
    assert want["b"] == (0.75, 0.9 - 0.75, 1)
    # the replayed ledger goes on charging, and the writer's package reads
    # the appended record back too
    replayed.charge("a", 0.25)
    replayed.close()
    again = wmod.BudgetLedger(p)
    assert again.spent("a") == want["a"][0] + 0.25
    assert again.report("a")["charges"] == want["a"][2] + 1
    again.close()
