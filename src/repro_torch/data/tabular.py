"""Tabular data plane: the paper's benchmark schemas + data generators.

Domain sizes are the paper's exactly (§8): Adult (14 attrs, universe
6.41e17) and Synth-n^d.  Accuracy metrics
in the paper are data-independent, so synthetic data suffice for end-to-end
runs.  The port's copy of ``repro.data.tabular``, plus
:func:`mixture_marginals` for domains too wide to draw records for.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.core.domain import Clique, Domain

ADULT_SIZES = [100, 100, 100, 99, 85, 42, 16, 15, 9, 7, 6, 5, 2, 2]


def adult_domain() -> Domain:
    return Domain.create(ADULT_SIZES, names=[f"adult{i}" for i in range(14)])


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
    """
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(components)) * float(n_records)
    probs = [rng.dirichlet(np.ones(a.size), size=components)
             for a in domain.attributes]
    out: Dict[Clique, np.ndarray] = {}
    for c in cliques:
        t = w[:, None]
        for i in c:
            t = (t[:, :, None] * probs[i][:, None, :]).reshape(components, -1)
        out[c] = t.sum(axis=0)
    return out
