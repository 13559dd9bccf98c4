"""The benchmark's inputs, made from ``--seed``: frozen copies of the
program's data generators.

The program's ``repro_torch.data.tabular`` holds the originals
(``synthetic_records``, ``marginals_from_records``, ``mixture_marginals``)
and ``repro_torch.core.partition.group_rows``.  A later change to the
program must not change what the benchmark feeds it, so the benchmark
keeps its own copies, and both the program and the plain reference are
handed the same tables from here.

A configuration's ``data`` entry names the generator (``kind``) and its
parameters; :func:`make_marginals` returns the exact marginal table of
every clique asked for, float64 host arrays keyed by clique.
"""
from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

Clique = Tuple[int, ...]


def closure(cliques: Sequence[Clique]) -> List[Clique]:
    """Every subset of every clique, sorted by (length, value)."""
    seen = set()
    for c in cliques:
        for r in range(len(c) + 1):
            seen.update(itertools.combinations(c, r))
    return sorted(seen, key=lambda c: (len(c), c))


def workload_cliques(n_attrs: int, k: int, include_lower: bool) -> List[Clique]:
    """All k-way cliques (all 1..k-way with ``include_lower``)."""
    ks = range(1, k + 1) if include_lower else [k]
    return [c for kk in ks for c in itertools.combinations(range(n_attrs), kk)]


def cells(sizes: Sequence[int], clique: Clique) -> int:
    out = 1
    for i in clique:
        out *= int(sizes[i])
    return out


def seed_int(seed: int, stream: int) -> int:
    """A 63-bit integer drawn from (``seed``, ``stream``): every use of the
    run's seed takes its own stream, so none shifts another."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), int(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# --------------------------------------------------------------------------
# records (copy of repro_torch.data.tabular.synthetic_records and
# marginals_from_records)
# --------------------------------------------------------------------------

def synthetic_records(sizes: Sequence[int], n_records: int, seed: int,
                      skew: float = 1.2) -> np.ndarray:
    """(N, n_attrs) int32 records with mildly Zipfian per-attribute values."""
    rng = np.random.default_rng(seed)
    cols = []
    for size in sizes:
        w = 1.0 / np.arange(1, size + 1) ** skew
        w /= w.sum()
        cols.append(rng.choice(size, size=n_records, p=w))
    return np.stack(cols, axis=1).astype(np.int32)


def marginals_from_records(sizes: Sequence[int], cliques: Sequence[Clique],
                           records: np.ndarray) -> Dict[Clique, np.ndarray]:
    """Exact marginal tables of ``records``, float64."""
    out: Dict[Clique, np.ndarray] = {}
    for c in cliques:
        if not c:
            out[c] = np.array([records.shape[0]], dtype=np.float64)
            continue
        flat = np.zeros(records.shape[0], dtype=np.int64)
        for col in c:
            flat = flat * sizes[col] + records[:, col]
        out[c] = np.bincount(flat, minlength=cells(sizes, c)).astype(np.float64)
    return out


# --------------------------------------------------------------------------
# mixture (copy of repro_torch.data.tabular.mixture_marginals and
# repro_torch.core.partition.group_rows)
# --------------------------------------------------------------------------

#: float64 entries of a batch's (cliques, components, cells) array.
MIXTURE_BATCH_CELLS = 1 << 20


def group_rows(sig: np.ndarray) -> List[np.ndarray]:
    """The groups of equal rows of an integer matrix: index arrays, each
    ascending, the groups in the lexicographic order of their rows."""
    sig = np.asarray(sig, np.int64)
    if not len(sig):
        return []
    sig = sig - sig.min(axis=0)
    words, word, span = [], np.zeros(len(sig), np.int64), 1
    for j, rj in enumerate((sig.max(axis=0) + 1).tolist()):
        if span * rj >= 1 << 62:
            words.append(word)
            word, span = np.zeros(len(sig), np.int64), 1
        word = word * rj + sig[:, j]
        span *= rj
    packed = np.stack(words + [word], axis=1)
    order = np.lexsort(packed.T[::-1])
    cuts = np.flatnonzero(np.any(np.diff(packed[order], axis=0), axis=1)) + 1
    return np.split(order, cuts)


def mixture_marginals(sizes: Sequence[int], cliques: Sequence[Clique],
                      n_records: float, seed: int, components: int = 4,
                      threads: int = 8) -> Dict[Clique, np.ndarray]:
    """Exact marginals of a seeded latent-class mixture of ``n_records``.

    x = n · Σ_c w_c ⊗_i p_{c,i}, with Dirichlet weights and per-attribute
    probabilities from ``seed``; every table is a true marginal of that one
    x, at any width, with no universe materialized.  Cliques of one tuple of
    sizes are computed together, a batch at a time, batches on up to
    ``threads`` threads; a table is a row of its batch's array."""
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(components)) * float(n_records)
    probs = [rng.dirichlet(np.ones(n), size=components) for n in sizes]
    sizes = np.asarray(sizes, np.int64)
    stacked, slot = {}, np.zeros(len(sizes), np.int64)
    for n in np.unique(sizes).tolist():
        ids = np.flatnonzero(sizes == n)
        stacked[n] = np.stack([probs[i] for i in ids])        # (a, C, n)
        slot[ids] = np.arange(len(ids))
    out: Dict[Clique, np.ndarray] = dict.fromkeys(cliques)
    by_width: Dict[int, list] = {}
    for c in out:
        by_width.setdefault(len(c), []).append(c)
    batches = []
    for k, cl in by_width.items():
        if k == 0:
            out[()] = w[:, None].sum(axis=0)
            continue
        mat = np.asarray(cl, np.int64).reshape(len(cl), k)
        sig = sizes[mat]
        for grp in group_rows(sig):
            shape = sig[grp[0]].tolist()
            step = max(1, MIXTURE_BATCH_CELLS
                       // (components * int(np.prod(shape))))
            for lo in range(0, len(grp), step):
                rows = grp[lo:lo + step].tolist()
                batches.append(([cl[r] for r in rows], mat[rows], shape))

    def tables(batch):
        _, attrs, shape = batch
        t = np.broadcast_to(w[None, :, None], (len(attrs), components, 1))
        for j, n in enumerate(shape):
            p = stacked[n][slot[attrs[:, j]]]               # (g, C, n)
            t = (t[:, :, :, None] * p[:, :, None, :]).reshape(
                len(attrs), components, -1)
        return t.sum(axis=1)

    with ThreadPoolExecutor(max(1, min(threads, os.cpu_count() or 1))) as pool:
        for batch, tab in zip(batches, pool.map(tables, batches)):
            out.update(zip(batch[0], tab))
    return out


def make_marginals(data: dict, sizes: Sequence[int], cliques: Sequence[Clique],
                   seed: int) -> Dict[Clique, np.ndarray]:
    """The exact marginal of every clique in ``cliques`` under the
    configuration's ``data`` entry, from ``seed``."""
    kind = data["kind"]
    if kind == "records":
        recs = synthetic_records(sizes, int(data["records"]), seed,
                                 float(data.get("skew", 1.2)))
        return marginals_from_records(sizes, cliques, recs)
    if kind == "mixture":
        return mixture_marginals(sizes, cliques, float(data["mass"]), seed,
                                 int(data.get("components", 4)))
    raise ValueError(f"unknown data kind {kind!r}")
