"""Attribute domains, cliques (attribute subsets) and marginal workloads.

The port's own copy of ``repro.core.domain`` (pure Python): importing that
module would run ``repro/core/__init__.py``, which imports jax.

A clique is a sorted tuple of attribute indices; the marginal on clique ``A``
is the table of counts over the cross-product of those attributes' values.
Everything downstream (residual bases, noise planning, reconstruction) is
keyed on cliques, never on the exponentially-large record universe.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

Clique = Tuple[int, ...]


def as_clique(attrs: Iterable[int]) -> Clique:
    return tuple(sorted(set(int(a) for a in attrs)))


@dataclass(frozen=True)
class Attribute:
    """A single column of the tabular domain."""

    name: str
    size: int
    kind: str = "categorical"  # categorical | numeric

    def __post_init__(self):
        if self.size < 2:
            raise ValueError(f"attribute {self.name!r} must have size >= 2, got {self.size}")


@dataclass(frozen=True)
class Domain:
    """An ordered collection of attributes; the record universe is their product."""

    attributes: Tuple[Attribute, ...]

    @staticmethod
    def create(sizes: Sequence[int], names: Optional[Sequence[str]] = None,
               kinds: Optional[Sequence[str]] = None) -> "Domain":
        names = names or [f"attr{i}" for i in range(len(sizes))]
        kinds = kinds or ["categorical"] * len(sizes)
        return Domain(tuple(Attribute(n, int(s), k) for n, s, k in zip(names, sizes, kinds)))

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(a.size for a in self.attributes)

    @property
    def n_attrs(self) -> int:
        return len(self.attributes)

    def universe_size(self) -> int:
        return math.prod(self.sizes)

    def clique_sizes(self, clique: Clique) -> Tuple[int, ...]:
        return tuple(self.attributes[i].size for i in clique)

    def n_cells(self, clique: Clique) -> int:
        """Number of cells in the marginal on ``clique`` (1 for the empty clique)."""
        return math.prod(self.clique_sizes(clique)) if clique else 1

    def residual_size(self, clique: Clique) -> int:
        """Rows of the residual matrix R_A:  prod (|Att_i| - 1)."""
        return math.prod(s - 1 for s in self.clique_sizes(clique)) if clique else 1

    def index(self, name: str) -> int:
        for i, a in enumerate(self.attributes):
            if a.name == name:
                return i
        raise KeyError(name)

    def clique_by_names(self, names: Iterable[str]) -> Clique:
        return as_clique(self.index(n) for n in names)


def subsets(clique: Clique) -> List[Clique]:
    """All subsets of a clique, including the empty clique, sorted by (len, value)."""
    out: List[Clique] = []
    for r in range(len(clique) + 1):
        out.extend(itertools.combinations(clique, r))
    return out


def closure(cliques: Iterable[Clique]) -> List[Clique]:
    """Downward closure: every subset of every workload clique (Thm 1/2)."""
    seen = set()
    for c in cliques:
        for s in subsets(as_clique(c)):
            seen.add(s)
    return sorted(seen, key=lambda c: (len(c), c))


@dataclass(frozen=True)
class MarginalWorkload:
    """A weighted collection of marginal queries.

    ``weights[A]`` is the importance Imp_A from Section 6 of the paper.
    """

    domain: Domain
    cliques: Tuple[Clique, ...]
    weights: Mapping[Clique, float] = field(default_factory=dict)

    def __post_init__(self):
        for c in self.cliques:
            for i in c:
                if not (0 <= i < self.domain.n_attrs):
                    raise ValueError(f"clique {c} out of range for domain with "
                                     f"{self.domain.n_attrs} attributes")

    def weight(self, clique: Clique) -> float:
        return float(self.weights.get(clique, 1.0))

    def weight_array(self) -> "np.ndarray":
        """Importance Imp_A per workload clique, in ``self.cliques`` order —
        the row-weight vector of the arrayized planner IR."""
        import numpy as np
        return np.array([self.weight(c) for c in self.cliques])

    def closure(self) -> List[Clique]:
        return closure(self.cliques)

    def total_cells(self) -> int:
        return sum(self.domain.n_cells(c) for c in self.cliques)

    def reweighted(self, scheme: str) -> "MarginalWorkload":
        """Weighting schemes from §6.2: equi | cells | sqrt_cells."""
        if scheme == "equi":
            w = {c: 1.0 for c in self.cliques}
        elif scheme == "cells":
            w = {c: float(self.domain.n_cells(c)) for c in self.cliques}
        elif scheme == "sqrt_cells":
            w = {c: math.sqrt(self.domain.n_cells(c)) for c in self.cliques}
        else:
            raise ValueError(scheme)
        return MarginalWorkload(self.domain, self.cliques, w)


def all_kway(domain: Domain, k: int, include_lower: bool = False,
             include_empty: bool = False) -> MarginalWorkload:
    """The workload of all k-way marginals (or all <=k-way with include_lower)."""
    cliques: List[Clique] = []
    ks = range(0 if include_empty else 1, k + 1) if include_lower else [k]
    for kk in ks:
        cliques.extend(itertools.combinations(range(domain.n_attrs), kk))
    return MarginalWorkload(domain, tuple(cliques))
