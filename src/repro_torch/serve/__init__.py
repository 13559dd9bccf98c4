"""Multi-tenant release serving tier: the port of ``repro.serve``.

* :mod:`repro_torch.serve.ledger` — durable per-tenant zCDP budget ledger
  (append-only JSONL journal, charge-before-measure, crash-recovery replay;
  the JAX package's journal format);
* :mod:`repro_torch.serve.server` — async request queue + worker loop with
  cross-tenant signature batching over
  :func:`repro_torch.engine.multi.measure_multi`, on the card by default;
* :mod:`repro_torch.serve.pool` — engine warm pool (pin hot signatures,
  evict by tenant-weighted LRU) over the instrumented engine cache;
* :mod:`repro_torch.serve.stats` — per-tenant/server counters behind
  ``/stats`` and ``/metrics``.
"""
from .ledger import (BudgetLedger, LedgerCorrupt, LedgerError, LedgerFailed,
                     UnknownTenant)
from .pool import EnginePool
from .server import (ReleaseRequest, ReleaseResult, ReleaseServer,
                     start_stats_http)
from .stats import ServerStats, TenantStats

__all__ = [
    "BudgetLedger", "LedgerCorrupt", "LedgerError", "LedgerFailed",
    "UnknownTenant",
    "EnginePool", "ReleaseRequest", "ReleaseResult", "ReleaseServer",
    "start_stats_http", "ServerStats", "TenantStats",
]
