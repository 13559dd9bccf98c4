"""Tabular data plane: the paper's benchmark schemas + data generators.

Domain sizes are the paper's exactly (§8): Adult (14 attrs, universe
6.41e17), CPS (5 attrs), Loans (12 attrs), and Synth-n^d.  Accuracy metrics
in the paper are data-independent, so synthetic data suffice for end-to-end
runs.  The port's copy of ``repro.data.tabular``, plus
:func:`mixture_marginals` for domains too wide to draw records for.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.domain import Clique, Domain
from repro_torch.core.partition import group_rows

ADULT_SIZES = [100, 100, 100, 99, 85, 42, 16, 15, 9, 7, 6, 5, 2, 2]
CPS_SIZES = [100, 50, 7, 4, 2]
LOANS_SIZES = [101, 101, 101, 101, 3, 8, 36, 6, 51, 4, 5, 15]


def adult_domain() -> Domain:
    return Domain.create(ADULT_SIZES, names=[f"adult{i}" for i in range(14)])


def cps_domain() -> Domain:
    return Domain.create(CPS_SIZES, names=[f"cps{i}" for i in range(5)])


def loans_domain() -> Domain:
    return Domain.create(LOANS_SIZES, names=[f"loans{i}" for i in range(12)])


def synth_domain(n: int, d: int, kind: str = "categorical") -> Domain:
    return Domain.create([n] * d, names=[f"x{i}" for i in range(d)],
                         kinds=[kind] * d)


def synthetic_records(domain: Domain, n_records: int, seed: int = 0,
                      skew: float = 1.2) -> np.ndarray:
    """(N, n_attrs) int32 records with mildly Zipfian per-attribute values."""
    rng = np.random.default_rng(seed)
    cols = []
    for a in domain.attributes:
        w = 1.0 / np.arange(1, a.size + 1) ** skew
        w /= w.sum()
        cols.append(rng.choice(a.size, size=n_records, p=w))
    return np.stack(cols, axis=1).astype(np.int32)


def marginals_from_records(domain: Domain, cliques: Sequence[Clique],
                           records: np.ndarray) -> Dict[Clique, np.ndarray]:
    """Exact marginal tables (host/NumPy path)."""
    out: Dict[Clique, np.ndarray] = {}
    for c in cliques:
        if not c:
            out[c] = np.array([records.shape[0]], dtype=np.float64)
            continue
        sizes = [domain.attributes[i].size for i in c]
        flat = np.zeros(records.shape[0], dtype=np.int64)
        for i, col in enumerate(c):
            flat = flat * sizes[i] + records[:, col]
        out[c] = np.bincount(flat, minlength=int(np.prod(sizes))).astype(np.float64)
    return out


def mixture_marginals(domain: Domain, cliques: Sequence[Clique],
                      n_records: float, seed: int = 0,
                      components: int = 4) -> Dict[Clique, np.ndarray]:
    """Exact marginals of a seeded latent-class mixture of ``n_records``.

    The data are the expected counts of a mixture of ``components`` product
    distributions (Dirichlet weights and per-attribute probabilities from
    ``seed``): x = n · Σ_c w_c ⊗_i p_{c,i}.  Every table is a true marginal
    of that one x, so the tables agree with each other — as a release needs —
    at any width, with no records drawn and no universe materialized.

    Cliques with one tuple of attribute sizes are computed together, a
    batch at a time and batches on up to 8 threads, with the per-clique
    rule's products and sum: each table is bit-equal to that clique
    computed alone.  A table is a row of its batch's array.
    """
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(components)) * float(n_records)
    probs = [rng.dirichlet(np.ones(a.size), size=components)
             for a in domain.attributes]
    sizes = np.asarray(domain.sizes, np.int64)
    # per size: every attribute's probabilities of that size, stacked
    stacked, slot = {}, np.zeros(len(sizes), np.int64)
    for n in np.unique(sizes).tolist():
        ids = np.flatnonzero(sizes == n)
        stacked[n] = np.stack([probs[i] for i in ids])        # (a, C, n)
        slot[ids] = np.arange(len(ids))
    out: Dict[Clique, np.ndarray] = dict.fromkeys(cliques)
    by_width: Dict[int, list] = {}
    for c in out:
        by_width.setdefault(len(c), []).append(c)
    batches = []                    # (cliques, their attributes, shape)
    for k, cl in by_width.items():
        if k == 0:
            out[()] = w[:, None].sum(axis=0)
            continue
        mat = np.asarray(cl, np.int64).reshape(len(cl), k)
        sig = sizes[mat]
        for grp in group_rows(sig):
            shape = sig[grp[0]].tolist()
            step = max(1, _MIXTURE_BATCH_CELLS
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

    # numpy lets go of the GIL inside its loops: batches run side by side
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for batch, tab in zip(batches, pool.map(tables, batches)):
            out.update(zip(batch[0], tab))
    return out


#: float64 entries of a batch's (cliques, components, cells) array.
_MIXTURE_BATCH_CELLS = 1 << 20
