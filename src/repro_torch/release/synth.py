r"""Scalable synthetic-record generation from released marginals.

The port of ``repro.release.synth``.  Given a *non-negative, mutually
consistent* family of marginals (``nonneg_release``), records are sampled by
round-robin conditional sampling over a clique junction order:

* a greedy junction order visits one attribute at a time, conditioning each
  on the already-sampled attributes it co-occurs with in the workload clique
  of maximal overlap (for tree-shaped workloads this is exact: the sampled
  joint reproduces every workload marginal in expectation);
* every attribute's draw is vectorized across all N records on the device:
  one parent-cell index, and one categorical draw per record by the inverse
  CDF of its parent cell's conditional row (one uniform from the caller's
  ``torch.Generator`` per record), so millions of rows per call and never a
  contingency table.  The JAX package draws a categorical from split keys
  of its own generator; the two agree in distribution, not bit for bit;
* :class:`SynthReport` audits the output: per workload marginal, the sampled
  table is compared against the released one (total-variation distance,
  ℓ∞, and a χ² statistic with its degrees of freedom).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.domain import Clique, Domain
from repro_torch.kernels.kron_matvec._layout import resolve_device

SamplingStep = Tuple[int, Clique, Clique]     # (attribute, clique, parents)


def junction_order(domain: Domain, cliques: Sequence[Clique],
                   attr_order: Optional[Sequence[int]] = None
                   ) -> List[SamplingStep]:
    """Greedy junction order: each attribute conditions on the sampled
    attributes of its best-overlapping workload clique.

    An attribute's best clique is, among the cliques that hold it, the one
    with the most already-sampled attributes, then the shortest, then the
    first in ``cliques``.  ``attr_order`` fixes the visiting order
    (default: pick the attribute whose best clique overlaps the sampled set
    the most, ties by index — chains and trees come out in exact Markov
    order).  The JAX package scans every clique for every attribute at
    every step; the port keeps each clique's overlap count and each
    attribute's best key, and a step updates them over the incidences of
    the cliques that hold the sampled attribute only (the same steps, so
    wide workloads order in seconds).
    """
    cliques = [c for c in cliques if c]
    covered = set(i for c in cliques for i in c)
    missing = set(range(domain.n_attrs)) - covered
    if missing:
        raise ValueError(f"attributes {sorted(missing)} appear in no "
                         "workload clique; cannot sample them")
    d, m = domain.n_attrs, len(cliques)
    lens = np.fromiter(map(len, cliques), np.int64, count=m)
    first = np.cumsum(lens) - lens          # clique j's first incidence
    inc_clique = np.repeat(np.arange(m, dtype=np.int64), lens)
    inc_attr = np.fromiter((a for c in cliques for a in c), np.int64,
                           count=int(lens.sum()))
    by_attr = np.lexsort((inc_clique, inc_attr))
    starts = np.searchsorted(inc_attr[by_attr], np.arange(d))
    # key of clique j: (overlap, -len, -j) as one int64, larger is better
    span = int(lens.max()) + 1
    static = (span - lens) * m + (m - 1 - np.arange(m, dtype=np.int64))
    overlap = np.zeros(m, np.int64)
    # each attribute's best key over its cliques; a step raises the keys
    # of the cliques that hold the sampled attribute only, so each of
    # their attributes' best becomes the max of its old best and theirs
    best = np.maximum.reduceat(static[inc_clique[by_attr]], starts)
    sampled = np.zeros(d, bool)
    steps: List[SamplingStep] = []
    fixed = None if attr_order is None else [int(a) for a in attr_order]
    for t in range(d if fixed is None else len(fixed)):
        if fixed is None:
            k = np.where(sampled, -1, best // (span * m))
            i = int(np.argmax(k))                          # ties: lowest id
        else:
            i = fixed[t]
        c = cliques[m - 1 - int(best[i] % m)]
        parents = tuple(sorted(a for a in c if sampled[a]))
        steps.append((i, c, parents))
        sampled[i] = True
        hi = starts[i + 1] if i + 1 < d else len(inc_clique)
        grown = inc_clique[by_attr[starts[i]:hi]]
        overlap[grown] += 1
        n = lens[grown]
        at = np.repeat(first[grown] - np.cumsum(n) + n, n) + np.arange(
            int(n.sum()))
        np.maximum.at(best, inc_attr[at], np.repeat(
            overlap[grown] * (span * m) + static[grown], n))
    return steps


def _conditional_table(domain: Domain, table: np.ndarray, clique: Clique,
                       attr: int, parents: Clique) -> np.ndarray:
    """(Π n_parents, n_attr) conditional probability rows from a marginal.

    Marginalizes the clique down to parents ∪ {attr}, moves the attribute
    axis last, clips negatives and row-normalizes (zero rows → uniform).
    """
    sizes = domain.clique_sizes(clique)
    t = np.asarray(table, np.float64).reshape(sizes)
    keep = set(parents) | {attr}
    drop = tuple(ax for ax, a in enumerate(clique) if a not in keep)
    if drop:
        t = t.sum(axis=drop)
    kept = [a for a in clique if a in keep]          # clique order, sorted
    t = np.moveaxis(t, kept.index(attr), -1)         # parents..., attr
    t = np.maximum(t.reshape(-1, domain.attributes[attr].size), 0.0)
    s = t.sum(axis=1, keepdims=True)
    uniform = np.full(t.shape[1], 1.0 / t.shape[1])
    return np.where(s > 0, t / np.maximum(s, 1e-300), uniform)


def _cdf_rows(probs: np.ndarray) -> np.ndarray:
    """Row-wise cumulative distribution, non-decreasing and at most 1, the
    last column exactly 1: every uniform in [0, 1) falls in some column."""
    cdf = np.minimum(np.cumsum(probs, axis=1), 1.0)
    cdf[:, -1] = 1.0
    return cdf


def synthesize_records(domain: Domain, tables: Mapping[Clique, np.ndarray],
                       n_records: int, gen: torch.Generator,
                       order: Optional[Sequence[SamplingStep]] = None,
                       batch: Optional[int] = None,
                       device=None) -> np.ndarray:
    """Sample (n_records, n_attrs) int32 records matching the marginals.

    ``tables`` must be non-negative (``nonneg_release`` output); the sampler
    only ever touches per-clique tables and (N,)-vectors — the contingency
    table is never materialized.  ``gen`` is a ``torch.Generator`` on
    ``device`` (CUDA unless ``device="cpu"``); the attributes are drawn in
    junction order and each attribute's records in ``batch``-sized chunks
    (default: all at once), which bounds the (chunk, n_attr) gather of
    conditional rows.  One seed gives the same records on every call.
    """
    if order is None:
        order = junction_order(domain, list(tables.keys()))
    n = int(n_records)
    if n <= 0:
        raise ValueError(f"n_records must be positive, got {n_records}")
    dev = resolve_device(device)
    out = torch.empty((n, domain.n_attrs), dtype=torch.int64, device=dev)
    ranges = [(0, n)] if batch is None else \
        [(s, min(s + int(batch), n)) for s in range(0, n, int(batch))]
    for attr, clique, parents in order:
        cdf = torch.as_tensor(_cdf_rows(_conditional_table(
            domain, tables[clique], clique, attr, parents)), device=dev)
        pidx = torch.zeros(n, dtype=torch.int64, device=dev)
        for a, s in zip(parents, domain.clique_sizes(parents)):
            pidx = pidx * s + out[:, a]
        for lo, hi in ranges:
            u = torch.rand((hi - lo, 1), generator=gen, dtype=torch.float64,
                           device=dev)
            out[lo:hi, attr] = torch.searchsorted(cdf[pidx[lo:hi]], u,
                                                  right=True)[:, 0]
    return out.to(torch.int32).cpu().numpy()


@dataclass
class MarginalCheck:
    clique: Clique
    cells: int
    tv: float          # total-variation distance, sampled vs released
    linf: float        # max abs cell deviation (count scale)
    chi2: float        # Σ (observed − expected)² / expected over e ≥ 5 cells
    dof: int           # number of cells entering the χ² sum − 1

    def chi2_ok(self, z: float = 6.0) -> bool:
        """χ² within mean + z·sd of its asymptotic distribution (dof large)."""
        if self.dof <= 0:
            return True
        return self.chi2 <= self.dof + z * np.sqrt(2.0 * self.dof)


@dataclass
class SynthReport:
    """Per-marginal audit of sampled records against the released tables."""

    n_records: int
    total: float
    checks: List[MarginalCheck]

    @property
    def max_tv(self) -> float:
        return max((c.tv for c in self.checks), default=0.0)

    def ok(self, z: float = 6.0) -> bool:
        return all(c.chi2_ok(z) for c in self.checks)

    def summary(self) -> str:
        worst = max(self.checks, key=lambda c: c.tv, default=None)
        return (f"SynthReport(n={self.n_records}, marginals="
                f"{len(self.checks)}, max_tv={self.max_tv:.4f}"
                + (f" at {worst.clique}" if worst else "") + ")")


def synth_report(domain: Domain, tables: Mapping[Clique, np.ndarray],
                 records: np.ndarray, total: Optional[float] = None
                 ) -> SynthReport:
    """Compare the sampled records' marginals against the released tables."""
    from repro_torch.data.tabular import marginals_from_records
    n = records.shape[0]
    cliques = [c for c in tables.keys() if c]
    sampled = marginals_from_records(domain, cliques, np.asarray(records))
    checks: List[MarginalCheck] = []
    for c in cliques:
        rel = np.asarray(tables[c], np.float64).reshape(-1)
        t = float(rel.sum()) if total is None else float(total)
        obs = sampled[c]
        if t <= 0:
            checks.append(MarginalCheck(c, rel.size, 0.0, 0.0, 0.0, 0))
            continue
        p = rel / t
        exp = p * n
        tv = 0.5 * float(np.abs(obs / n - p).sum())
        linf = float(np.abs(obs - exp).max())
        use = exp >= 5.0
        dof = max(int(use.sum()) - 1, 0)
        chi2 = float((((obs - exp) ** 2)[use] / exp[use]).sum()) if dof else 0.0
        checks.append(MarginalCheck(c, rel.size, tv, linf, chi2, dof))
    return SynthReport(n, float(total) if total is not None else -1.0, checks)
