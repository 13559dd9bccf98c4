"""Engine warm pool: pin hot engines, evict by tenant-weighted LRU.

The port of ``repro.serve.pool``.  Wraps a private
:class:`~repro_torch.engine.sharded._EngineCache` (same machinery the
sharded path uses, so instrumentation and weakref hygiene are shared) and
drives its warm-pool hooks from observed traffic:

* every serve records (cache key, tenant); an entry's score is
  ``Σ_t uses[key][t] / total_uses[t]`` — each tenant contributes the
  *fraction of its own traffic* that hit this engine, so one hyperactive
  tenant cannot starve the warm engines of everyone else;
* the ``pin_count`` highest-scoring live entries are pinned (never evicted
  while pinned — the "hot signatures" of the traffic mix);
* a full cache evicts the lowest-scoring unpinned entry (ties → LRU) via the
  cache's ``evict_score`` hook instead of pure LRU.

Engines live on one device each, and the device is part of the cache key:
``None``, ``"cuda"`` and ``"cuda:<current>"`` resolve to one device and so
to one entry.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, Optional

from repro_torch.core.mechanism import noise_dtype
from repro_torch.engine.sharded import _EngineCache
from repro_torch.kernels.kron_matvec._layout import resolve_device


class EnginePool:
    """Tenant-aware engine cache with pinning + weighted eviction.

    Thread-safe: ``engine_for`` and ``stats`` serialize on one lock, so a
    tenant registration warming an engine on the caller thread can never
    corrupt the cache OrderedDict a running worker is using, and a /stats
    snapshot never iterates entries mid-mutation.
    """

    def __init__(self, maxsize: Optional[int] = None, pin_count: int = 2):
        self.cache = _EngineCache(maxsize)
        self.cache.evict_score = self._score
        self.pin_count = int(pin_count)
        self._lock = threading.Lock()
        self._uses: Dict[tuple, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int))                  # guarded-by: _lock
        self._tenant_total: Dict[str, int] = defaultdict(int)  # guarded-by: _lock

    def engine_for(self, tenant: str, plan, use_kernel: Optional[bool] = None,
                   dtype=None, secure: bool = False, digits: int = 4,
                   device=None):
        """Cached engine for ``plan`` on ``device`` (CUDA unless
        ``device="cpu"``), accounted to ``tenant``; ``use_kernel`` defaults
        to the kernels."""
        dev = resolve_device(device)
        use_kernel = True if use_kernel is None else bool(use_kernel)
        dtype = noise_dtype() if dtype is None else dtype
        with self._lock:
            eng = self.cache.get(plan, use_kernel, dtype, secure, digits, dev)
            if eng is None:
                eng = plan.engine(use_kernel=use_kernel, precompile=False,
                                  dtype=dtype, secure=secure, digits=digits,
                                  device=dev)
                eng.stats.bump("cache_misses")
                self.cache.put(plan, use_kernel, dtype, eng, secure, digits,
                               dev)
            key = self.cache._key(plan, use_kernel, dtype, secure, digits, dev)
            self._uses[key][tenant] += 1
            self._tenant_total[tenant] += 1
            self._repin()
            return eng

    def _score(self, key: tuple) -> float:  # requires-lock: _lock
        return sum(n / self._tenant_total[t]
                   for t, n in self._uses.get(key, {}).items()
                   if self._tenant_total[t])

    def _repin(self) -> None:  # requires-lock: _lock
        live = list(self.cache._entries)
        # prune use counts for evicted/dead keys so scores track live traffic
        for k in [k for k in self._uses if k not in self.cache._entries]:
            del self._uses[k]
        top = sorted(live, key=self._score, reverse=True)[:self.pin_count]
        self.cache._pinned = set(top)

    def stats(self) -> dict:
        with self._lock:
            lookups = self.cache.hits + self.cache.misses
            return {"entries": len(self.cache), "hits": self.cache.hits,
                    "misses": self.cache.misses,
                    "hit_rate": (self.cache.hits / lookups) if lookups
                    else None,
                    "evictions": self.cache.evictions,
                    "forced_evictions": self.cache.forced_evictions,
                    "pinned": len(self.cache._pinned),
                    "snapshot": self.cache.snapshot()}
