"""Durable per-tenant zCDP budget ledger (append-only JSONL journal).

The port of ``repro.serve.ledger``: the same journal format, record for
record, so a journal written by either package replays in the other to the
same spend.

The serving tier's privacy guarantee reduces to one invariant: **no tenant's
journaled spend may ever understate what was actually measured against their
data**.  The ledger enforces it with charge-before-measure ordering:

1. under the ledger lock, the charge is validated against the in-memory
   :class:`~repro_torch.core.accountant.PrivacyBudget` (over-budget → immediate
   :class:`~repro_torch.core.accountant.BudgetExhausted` carrying the exact
   remaining ρ — nothing is journaled, nothing is measured);
2. the charge record is appended to the journal and fsync'd;
3. only then does the in-memory budget advance, and only after ``charge``
   returns may the caller run the measurement.

A crash between (2) and (3) — or any time after (2) — replays the journal on
restart and finds the charge already durable: the tenant is charged for a
measurement that may never have produced output.  That direction is
privacy-safe (budget is wasted, never leaked).  A crash before (2) charged
nothing and measured nothing.  There is no ordering in which noise was
released but the journal missed the charge.

Journal format: one JSON object per line, ``op`` ∈ {``register``,
``charge``}.  Replay tolerates exactly one trailing partial line (a crash
mid-append); corruption anywhere else raises :class:`LedgerCorrupt`.  A
*failed* append (ENOSPC, I/O error) truncates the file back to its pre-write
length so the partial record can never become a non-trailing line; if even
the truncate fails, the ledger marks itself failed and refuses all further
charges (:class:`LedgerFailed` — availability loss, never an under-charge).
"""
from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Dict, Optional

from repro_torch.core.accountant import BudgetExhausted, PrivacyBudget, zcdp_rho


class LedgerError(Exception):
    """Base class for ledger failures that are not budget rejections."""


class LedgerCorrupt(LedgerError):
    """A non-trailing journal line failed to parse — refuse to serve."""


class LedgerFailed(LedgerError):
    """A failed append could not be rolled back — the journal's on-disk tail
    is unknown, so the ledger refuses every further write."""


class UnknownTenant(LedgerError, KeyError):
    """Charge or query against a tenant id that was never registered."""


class BudgetLedger:
    """Per-tenant :class:`PrivacyBudget` map backed by a JSONL journal.

    Thread-safe: ``register``/``charge`` serialize on one lock, so concurrent
    worker threads can never jointly over-spend a tenant (the race test in
    tests/test_torch_ledger.py hammers this).  ``fsync=False`` trades crash
    durability for speed (benchmarks, tests that only need replay logic).
    """

    def __init__(self, path: str, fsync: bool = True):
        self.path = str(path)
        self.fsync = bool(fsync)
        self._lock = threading.Lock()
        self._budgets: Dict[str, PrivacyBudget] = {}
        self._charges: Dict[str, int] = {}          # per-tenant charge count
        self._failed = False
        self._metrics = None         # bound via bind_registry (obs subsystem)
        self._replayed = self._replay()
        # Unbuffered binary append: tell() is a byte offset and a failed
        # write leaves no hidden buffered tail, so _append can roll a
        # partial record back with one ftruncate.
        self._fh: Optional[io.RawIOBase] = open(  # noqa: SIM115 - lives until close()
            self.path, "ab", buffering=0)

    # ------------------------------------------------------------- replay
    def _replay(self) -> int:
        """Rebuild in-memory state from the journal; returns records applied.

        Charges are applied unconditionally — even a charge that (through a
        historical budget change) now exceeds the registered total still
        counts as spent.  Replay may over-charge relative to what a crashed
        process measured; it can never under-charge, because every
        measurement was preceded by a durable charge record.
        """
        if not os.path.exists(self.path):
            return 0
        applied = 0
        with open(self.path, "r", encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                rest = [ln for ln in lines[i + 1:] if ln.strip()]
                if rest:
                    raise LedgerCorrupt(
                        f"{self.path}:{i + 1}: unparseable journal line "
                        f"followed by {len(rest)} more — refusing to serve "
                        f"from a corrupt ledger") from None
                break                      # trailing partial line: crash tail
            op = rec.get("op")
            if op == "register":
                t = rec["tenant"]
                b = self._budgets.get(t)
                if b is None:
                    self._budgets[t] = PrivacyBudget(float(rec["pcost_total"]))
                    self._charges[t] = 0
                else:                      # re-register: keep spend, new total
                    b.total_pcost = float(rec["pcost_total"])
            elif op == "charge":
                t = rec["tenant"]
                if t not in self._budgets:
                    raise LedgerCorrupt(
                        f"{self.path}:{i + 1}: charge for unregistered "
                        f"tenant {t!r}")
                self._budgets[t].spent += float(rec["pcost"])
                self._charges[t] += 1
            else:
                raise LedgerCorrupt(f"{self.path}:{i + 1}: unknown op {op!r}")
            applied += 1
        return applied

    # ------------------------------------------------------------- journal
    def _append(self, rec: dict) -> None:
        """Durably append one record (caller holds the lock).

        On any write/fsync failure the file is truncated back to its
        pre-write length, so the journal never carries a non-trailing
        partial line; the in-memory budget never advanced, so the failed
        charge simply never happened.  If the truncate itself fails the
        ledger is marked failed and every later append raises
        :class:`LedgerFailed` rather than risk appending after a partial
        record.
        """
        if self._failed:
            raise LedgerFailed(
                f"{self.path}: a failed append could not be rolled back; "
                f"refusing further writes")
        data = (json.dumps(rec, separators=(",", ":")) + "\n").encode("utf-8")
        pos = self._fh.tell()
        try:
            n = self._fh.write(data)
            if n != len(data):
                raise OSError(f"short write: {n}/{len(data)} bytes")
            if self.fsync:
                os.fsync(self._fh.fileno())
        except Exception:
            try:
                os.ftruncate(self._fh.fileno(), pos)
                self._fh.seek(pos)
            except OSError:
                self._failed = True
            raise

    # ------------------------------------------------------------- metrics
    def bind_registry(self, registry) -> None:
        """Mirror charge/reject events + spend levels into ``registry``.

        Called by the owning :class:`~repro_torch.serve.server.ReleaseServer`; a
        standalone ledger stays metrics-free.  Only successful *journal*
        outcomes are mirrored — the gauges show the same numbers
        :meth:`report` does, because both read the same budgets.
        """
        self._metrics = {
            "charges": registry.counter(
                "repro_ledger_charges_total",
                "Durably journaled budget charges", labels=("tenant",)),
            "rejects": registry.counter(
                "repro_ledger_rejects_total",
                "Charges rejected as over-budget", labels=("tenant",)),
            "spent": registry.gauge(
                "repro_ledger_pcost_spent",
                "Journaled pcost spent", labels=("tenant",)),
            "total": registry.gauge(
                "repro_ledger_pcost_total",
                "Registered pcost budget", labels=("tenant",)),
        }
        with self._lock:
            for t, b in self._budgets.items():   # replayed state, up front
                self._metrics["spent"].labels(tenant=t).set(b.spent)
                self._metrics["total"].labels(tenant=t).set(b.total_pcost)

    def _mirror(self, kind: str, tenant: str, budget=None) -> None:
        m = self._metrics
        if m is None:
            return
        if kind in ("charges", "rejects"):
            m[kind].labels(tenant=tenant).inc()
        if budget is not None:
            m["spent"].labels(tenant=tenant).set(budget.spent)
            m["total"].labels(tenant=tenant).set(budget.total_pcost)

    # -------------------------------------------------------------- public
    @property
    def tenants(self):
        return tuple(self._budgets)

    @property
    def replayed_records(self) -> int:
        return self._replayed

    def register(self, tenant: str, rho: Optional[float] = None,
                 pcost: Optional[float] = None) -> None:
        """Create (or re-total) a tenant budget; durable before it returns.

        Exactly one of ``rho`` (zCDP) / ``pcost`` sets the total.  Registering
        an existing tenant updates the total and keeps the journaled spend —
        shrinking a total below the spend simply leaves the tenant with zero
        remaining budget.
        """
        if (rho is None) == (pcost is None):
            raise ValueError("pass exactly one of rho= / pcost=")
        total = 2.0 * float(rho) if rho is not None else float(pcost)
        if total < 0:
            raise ValueError(f"budget must be >= 0, got {total}")
        with self._lock:
            self._append({"op": "register", "tenant": tenant,
                          "pcost_total": total, "ts": time.time()})
            b = self._budgets.get(tenant)
            if b is None:
                b = self._budgets[tenant] = PrivacyBudget(total)
                self._charges[tenant] = 0
            else:
                b.total_pcost = total
            self._mirror("register", tenant, b)

    def charge(self, tenant: str, pcost: float,
               request_id: Optional[str] = None) -> None:
        """Atomically journal + apply a charge, or raise.

        Raises :class:`UnknownTenant` for unregistered tenants and
        :class:`~repro_torch.core.accountant.BudgetExhausted` (with the exact
        remaining ρ) when the charge does not fit.  On return the charge is
        durable — the caller may measure.
        """
        pcost = float(pcost)
        if pcost < 0:
            raise ValueError(f"charge must be >= 0, got {pcost}")
        with self._lock:
            b = self._budgets.get(tenant)
            if b is None:
                raise UnknownTenant(tenant)
            if not b.can_charge(pcost):
                self._mirror("rejects", tenant)
                raise BudgetExhausted(pcost, b.remaining, tenant)
            self._append({"op": "charge", "tenant": tenant, "pcost": pcost,
                          "request_id": request_id, "ts": time.time()})
            b.spent += pcost             # after the durable append, never before
            self._charges[tenant] += 1
            self._mirror("charges", tenant, b)

    def remaining(self, tenant: str) -> float:
        b = self._budgets.get(tenant)
        if b is None:
            raise UnknownTenant(tenant)
        return b.remaining

    def remaining_rho(self, tenant: str) -> float:
        return zcdp_rho(self.remaining(tenant))

    def spent(self, tenant: str) -> float:
        b = self._budgets.get(tenant)
        if b is None:
            raise UnknownTenant(tenant)
        return b.spent

    def report(self, tenant: Optional[str] = None) -> dict:
        """Accountant report per tenant (all tenants when ``tenant=None``)."""
        with self._lock:
            if tenant is not None:
                if tenant not in self._budgets:
                    raise UnknownTenant(tenant)
                return self._report_locked(tenant)
            return {t: self._report_locked(t) for t in self._budgets}

    def _report_locked(self, tenant: str) -> dict:
        b = self._budgets[tenant]
        rep = b.report()
        rep.update(tenant=tenant, charges=self._charges[tenant],
                   pcost_remaining=b.remaining,
                   rho_remaining=zcdp_rho(b.remaining))
        return rep

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "BudgetLedger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
