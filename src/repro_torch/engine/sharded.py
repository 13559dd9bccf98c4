"""Sharded measurement: marginal tables from record shards, one transform.

The port of ``repro.engine.sharded``.  Each rank holds its own shard of the
records; it builds the partial marginal table of every clique of the plan's
closure as an integer count on its device (one ``torch.bincount`` of the
flat cell index for many cliques at once — exact for counts, with no
one-hot matrix), the partial tables are summed across ranks with
``torch.distributed.all_reduce`` (one call for the whole closure), and the
residual transform and the noise then run on every rank with the same
generator state, so every rank holds the same noisy answers.  The JAX
package's ``shard_map`` over a mesh becomes a ``torch.distributed`` process
group (``group=None``: this process's records only).

The transform is served by whatever engine the plan's family provides
(``plan.engine(...)``): plain plans through
:class:`~repro_torch.engine.engine.MarginalEngine`, RP+ plans through
:class:`~repro_torch.engine.plus_engine.PlusEngine`, ``secure=True``
through :class:`~repro_torch.engine.discrete_engine.DiscreteEngine` and
divide-and-conquer plans through
:class:`~repro_torch.engine.composite.CompositeEngine`; the engines are
kept in an LRU cache keyed on the plan, so repeated calls reuse one engine.
"""
from __future__ import annotations

import os
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.domain import Clique, Domain
from repro_torch.core.mechanism import Measurement, noise_dtype
from repro_torch.core.plantable import BasePlan
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.obs import REGISTRY

# Process-wide engine-cache event feed for /metrics (per-cache ints stay on
# each _EngineCache instance; this family aggregates across caches).
_CACHE_EVENTS = REGISTRY.counter(
    "repro_engine_cache_events_total",
    "Engine-cache events (hit, miss, eviction, forced_eviction)",
    labels=("event",))

# Index elements (records x cliques x attributes) one bincount pass may
# gather at once: 2^25 int64 values, 256 MiB.
_PASS_ELEMS = 1 << 25


def _env_cache_size(default: int = 16) -> int:
    """REPRO_ENGINE_CACHE_SIZE env override of the engine-cache capacity."""
    raw = os.environ.get("REPRO_ENGINE_CACHE_SIZE", "")
    try:
        return max(1, int(raw))
    except ValueError:
        return default


def _dtype_name(dtype) -> str:
    """'float32' for torch.float32, np.float32 or 'float32'."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _device_name(device) -> str:
    """The cache key's device: ``None``, ``"cuda"`` and ``"cuda:<current>"``
    name one device, so they are one key (``"cuda:<current>"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


class _EngineCache:
    """LRU cache of serving engines, weak-safely keyed on the plan.

    Entries are keyed on ``(id(plan), use_kernel, dtype, secure, digits,
    device)`` but each holds a ``weakref`` to its plan and is validated with
    an identity check on every hit — a recycled ``id`` can never alias a
    stale engine.  A full cache evicts exactly one entry, the least recently
    used.  Cached engines pin their plan (``engine.plan``), so entries
    normally leave via LRU eviction; the per-plan ``weakref.finalize``
    additionally drops entries whose values don't pin the plan the moment
    it is collected.

    Capacity: constructor arg, else the ``REPRO_ENGINE_CACHE_SIZE``
    environment variable, else 16.  ``hits`` / ``misses`` aggregate across
    entries; each served engine's own ``EngineStats`` records its
    ``cache_hits`` / ``cache_misses``.

    Warm-pool hooks: ``pin``/``unpin`` exempt an entry from eviction (a
    full cache of pinned entries still evicts LRU — pins are advisory,
    counted in ``forced_evictions``), and an ``evict_score`` callback, when
    set, picks the victim with the LOWEST score among unpinned entries (ties
    broken LRU) instead of pure LRU.
    """

    def __init__(self, maxsize: Optional[int] = None):
        self.maxsize = _env_cache_size() if maxsize is None else int(maxsize)
        if self.maxsize < 1:
            raise ValueError(f"cache maxsize must be >= 1, got {maxsize}")
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.forced_evictions = 0
        self.evict_score = None        # Optional[Callable[[tuple], float]]
        self._pinned: set = set()
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._finalized: set = set()

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _child_plans(plan) -> tuple:
        """Child plans of a composite plan (empty for monolithic plans)."""
        return tuple(getattr(plan, "block_plans", None) or ())

    def _key(self, plan, use_kernel: bool, dtype, secure: bool = False,
             digits: int = 4, device=None) -> tuple:
        # digits is part of the key: a secure engine's σ̄/γ² are baked in at
        # construction, so two rationalizations must never share an engine.
        # Composite plans also key on their child-plan identities: a
        # composite entry is valid only while the exact block plans it was
        # built against are alive, and _drop_plan tells "this id is the
        # entry's own plan" (drop it) from "this id is one of its children"
        # (drop the parent, never the siblings).  The device is part of the
        # key: an engine's chains and generators live on one device.
        return ((id(plan), tuple(map(id, self._child_plans(plan)))),
                bool(use_kernel), _dtype_name(dtype),
                bool(secure), int(digits) if secure else None,
                _device_name(device))

    def get(self, plan, use_kernel: bool, dtype, secure: bool = False,
            digits: int = 4, device=None):
        key = self._key(plan, use_kernel, dtype, secure, digits, device)
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            _CACHE_EVENTS.labels(event="miss").inc()
            return None
        ref, child_refs, engine = ent
        stale = ref() is not plan      # id recycled: stale entry
        if not stale:
            children = self._child_plans(plan)
            stale = len(child_refs) != len(children) or any(
                r() is not c for r, c in zip(child_refs, children))
        if stale:
            del self._entries[key]
            self._pinned.discard(key)
            self.misses += 1
            _CACHE_EVENTS.labels(event="miss").inc()
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        _CACHE_EVENTS.labels(event="hit").inc()
        stats = getattr(engine, "stats", None)
        if stats is not None:          # cache values are engines in serving;
            stats.bump("cache_hits")   # tests may stash sentinels
        return engine

    def put(self, plan, use_kernel: bool, dtype, engine,
            secure: bool = False, digits: int = 4, device=None) -> None:
        key = self._key(plan, use_kernel, dtype, secure, digits, device)
        while len(self._entries) >= self.maxsize:
            self._evict_one()
        self._entries[key] = (weakref.ref(plan),
                              tuple(weakref.ref(c)
                                    for c in self._child_plans(plan)),
                              engine)
        if id(plan) not in self._finalized:
            self._finalized.add(id(plan))
            weakref.finalize(plan, self._drop_plan, id(plan))

    def _evict_one(self) -> None:
        """Evict one entry: lowest evict_score among unpinned (ties → LRU),
        else LRU among unpinned, else LRU outright (advisory pins)."""
        candidates = [k for k in self._entries if k not in self._pinned]
        if not candidates:                          # everything pinned
            self.forced_evictions += 1
            _CACHE_EVENTS.labels(event="forced_eviction").inc()
            victim = next(iter(self._entries))      # oldest = LRU
        elif self.evict_score is not None:
            order = {k: i for i, k in enumerate(self._entries)}
            victim = min(candidates,
                         key=lambda k: (self.evict_score(k), order[k]))
        else:
            victim = candidates[0]                  # LRU among unpinned
        del self._entries[victim]
        self._pinned.discard(victim)
        self.evictions += 1
        _CACHE_EVENTS.labels(event="eviction").inc()

    # ---------------------------------------------------------- warm pool
    def pin(self, plan, use_kernel: bool, dtype, secure: bool = False,
            digits: int = 4, device=None) -> None:
        self._pinned.add(self._key(plan, use_kernel, dtype, secure, digits,
                                   device))

    def unpin(self, plan, use_kernel: bool, dtype, secure: bool = False,
              digits: int = 4, device=None) -> None:
        self._pinned.discard(self._key(plan, use_kernel, dtype, secure,
                                       digits, device))

    def snapshot(self) -> list:
        """One dict per live entry (for /stats): key fields + pin state."""
        rows = []
        for key in self._entries:
            (pid, child_ids), use_kernel, dtype, secure, _digits, dev = key
            rows.append(dict(plan_id=pid, n_children=len(child_ids),
                             use_kernel=use_kernel, dtype=dtype,
                             secure=secure, device=dev,
                             pinned=key in self._pinned))
        return rows

    def _drop_plan(self, pid: int) -> None:
        # Drop entries OWNED by this plan id, and composite entries that held
        # it as a child (their engine references a dead block plan).  A dying
        # composite parent matches only its own entries — the children's
        # entries key on (child_id, ()) and survive, still serving any other
        # owner of those block plans.
        self._finalized.discard(pid)
        for k in [k for k in self._entries
                  if k[0][0] == pid or pid in k[0][1]]:
            del self._entries[k]
            self._pinned.discard(k)


# Engines cached per (plan, path, dtype, secure, device): repeated
# sharded_measure calls and composite engines over one plan reuse one
# engine.  Capacity from REPRO_ENGINE_CACHE_SIZE (default 16).
_ENGINE_CACHE = _EngineCache()


def _engine_for(plan: BasePlan, use_kernel: Optional[bool] = None,
                dtype=None, secure: bool = False, digits: int = 4,
                device=None):
    """The cached engine serving ``plan`` on ``device`` (CUDA unless
    ``device="cpu"``), built with ``plan.engine(precompile=False, ...)`` on
    a miss."""
    dev = resolve_device(device)
    use_kernel = True if use_kernel is None else use_kernel
    dtype = noise_dtype() if dtype is None else dtype
    eng = _ENGINE_CACHE.get(plan, use_kernel, dtype, secure, digits, dev)
    if eng is None:
        eng = plan.engine(use_kernel=use_kernel, precompile=False, dtype=dtype,
                          secure=secure, digits=digits, device=dev)
        eng.stats.bump("cache_misses")
        _ENGINE_CACHE.put(plan, use_kernel, dtype, eng, secure, digits, dev)
    return eng


def _clique_strides(domain: Domain, clique: Clique) -> Tuple[np.ndarray, int]:
    """Row-major strides of a clique's table (first attribute slowest) and
    its cell count."""
    sizes = [domain.attributes[i].size for i in clique]
    strides = np.ones(len(clique), np.int64)
    for j in range(len(clique) - 2, -1, -1):
        strides[j] = strides[j + 1] * sizes[j + 1]
    return strides, int(np.prod(sizes)) if clique else 1


def _local_counts(domain: Domain, cliques: Sequence[Clique],
                  records: torch.Tensor) -> torch.Tensor:
    """Integer counts of every clique's cells, concatenated in ``cliques``
    order: one flat int64 tensor on the records' device.

    Cliques of one width are counted together: the flat cell index of
    record r in clique j is ``off_j + Σ_a rec[r, c_ja] · stride_ja``, and
    one ``torch.bincount`` over all (r, j) pairs of a pass counts every
    table at once (a pass holds at most ``_PASS_ELEMS`` index elements).
    Counts are exact integers; the JAX package's one-hot matmul becomes
    this scatter of ones.
    """
    n_rec = records.shape[0]
    meta = [_clique_strides(domain, c) for c in cliques]
    cells = np.array([m[1] for m in meta], np.int64)
    offs = np.concatenate([[0], np.cumsum(cells)])
    out = torch.zeros(int(offs[-1]), dtype=torch.int64, device=records.device)
    by_width: Dict[int, List[int]] = {}
    for j, c in enumerate(cliques):
        by_width.setdefault(len(c), []).append(j)
    for k, idx in sorted(by_width.items()):
        if k == 0:
            for j in idx:
                out[int(offs[j])] = n_rec
            continue
        per_pass = max(1, _PASS_ELEMS // max(1, n_rec * k))
        for s in range(0, len(idx), per_pass):
            sel = np.asarray(idx[s:s + per_pass])
            local = np.concatenate([[0], np.cumsum(cells[sel])])
            cols = torch.as_tensor(np.array([cliques[j] for j in sel]),
                                   device=records.device)
            strides = torch.as_tensor(np.stack([meta[j][0] for j in sel]),
                                      device=records.device)
            base = torch.as_tensor(local[:-1], device=records.device)
            flat = base.expand(n_rec, -1).clone()          # (N, g)
            for a in range(k):
                flat += records[:, cols[:, a]] * strides[:, a]
            # the pass's tables, back to their places in ``out``
            dest = (np.repeat(offs[sel] - local[:-1], cells[sel])
                    + np.arange(local[-1]))
            out[torch.as_tensor(dest, device=records.device)] = torch.bincount(
                flat.reshape(-1), minlength=int(local[-1]))
    return out


def sharded_marginals(domain: Domain, cliques: Sequence[Clique], records,
                      group=None, device=None) -> Dict[Clique, np.ndarray]:
    """Exact marginal tables of every clique over the records of all ranks.

    ``records`` is this rank's (N, n_attrs) integer shard (numpy array or
    tensor); the counts are built on ``device`` (CUDA unless
    ``device="cpu"``).  ``group`` is a ``torch.distributed`` process group:
    each rank's counts are summed with ONE ``all_reduce(SUM)`` over the
    concatenated int64 tables (the group's backend must take tensors on
    ``device``: NCCL on CUDA, gloo on the CPU); ``group=None`` counts this
    process's records only.  Tables come back as float64 host arrays (exact
    below 2^53 per cell; the JAX package's tables take the noise dtype),
    flat in row-major cell order — the same tables as
    :func:`repro_torch.data.tabular.marginals_from_records`.
    """
    dev = resolve_device(device)
    cliques = list(cliques)
    rec = records if torch.is_tensor(records) else \
        torch.from_numpy(np.asarray(records))
    rec = rec.to(device=dev, dtype=torch.int64)
    counts = _local_counts(domain, cliques, rec)
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    host = counts.cpu().numpy().astype(np.float64)
    out: Dict[Clique, np.ndarray] = {}
    at = 0
    for c in cliques:
        n = domain.n_cells(c) if c else 1
        out[c] = host[at:at + n]
        at += n
    return out


def sharded_measure(plan: BasePlan, records, gen, group=None,
                    use_kernel: Optional[bool] = None, dtype=None,
                    secure: bool = False, digits: int = 4,
                    device=None) -> Dict[Clique, Measurement]:
    """Distributed Algorithms 1/5 (and 3): sharded marginalization, then the
    transform of the plan's engine.

    ``plan`` is any plan of the port (plain, RP+ or divide-and-conquer);
    the transform runs on the engine the plan provides (``plan.engine``),
    cached per (plan, path, dtype, secure, device), with ``gen`` the
    generator its ``measure`` takes (``secure=True``: a ``torch.Generator``,
    ``np.random.Generator`` or ``random.Random`` seeding the exact discrete
    Gaussian draws, ``digits`` the σ̄ rationalization; RP+ and
    divide-and-conquer plans raise there).  Every rank passes the same
    generator state and gets the same measurements.  ``dtype`` is the noise
    dtype (default float32); ``use_kernel`` defaults to the kernels.
    """
    margs = sharded_marginals(plan.domain, plan.cliques, records, group,
                              device=device)
    return _engine_for(plan, use_kernel, dtype, secure, digits,
                       device).measure(margs, gen)
