"""Residual bases: subtraction matrices, their pseudo-inverses, residual matrices.

Section 4.2 of the paper.  ``Sub_m`` is the (m-1) x m matrix with first column
all ones and -1 on the (i, i+1) superdiagonal; ``R_A = ⊗_i V_i`` with
``V_i = 1ᵀ`` for attributes outside A and ``Sub_{|Att_i|}`` inside A.
All objects here are tiny (per-attribute); they are the Kronecker *factors*
used by the implicit algebra in :mod:`repro_torch.core.kron`.  The port's
own copy of the parts of ``repro.core.residual`` the release path uses
(numpy, unchanged).
"""
from __future__ import annotations

import numpy as np

from .domain import Clique, Domain


def sub_matrix(m: int) -> np.ndarray:
    """Sub_m: (m-1) x m, first column 1, entries (i, i+1) = -1."""
    s = np.zeros((m - 1, m), dtype=np.float64)
    s[:, 0] = 1.0
    s[np.arange(m - 1), np.arange(1, m)] = -1.0
    return s


def sub_pinv(m: int) -> np.ndarray:
    """Sub_m^† in closed form (Lemma 1): (1/m) [[1ᵀ], [11ᵀ - m·I]], shape m x (m-1)."""
    top = np.ones((1, m - 1), dtype=np.float64)
    bot = np.ones((m - 1, m - 1), dtype=np.float64) - m * np.eye(m - 1)
    return np.vstack([top, bot]) / m


def sub_gram(m: int) -> np.ndarray:
    """Sub_m Sub_mᵀ = I + 11ᵀ  ((m-1) x (m-1)); the per-attribute covariance factor."""
    return np.eye(m - 1) + np.ones((m - 1, m - 1))


def p_coeff(domain: Domain, clique: Clique) -> float:
    """p_A = Π_{i∈A} (|Att_i|-1)/|Att_i| — the pcost coefficient of M_A (Thm 3)."""
    out = 1.0
    for s in domain.clique_sizes(clique):
        out *= (s - 1) / s
    return out


def variance_coeff(domain: Domain, sub_clique: Clique, clique: Clique) -> float:
    """Coefficient of σ²_{A'} in the per-cell variance of the marginal on A (Thm 4):

        p_{A'} · Π_{j ∈ A \\ A'} 1/|Att_j|²     (requires A' ⊆ A).
    """
    if not set(sub_clique) <= set(clique):
        raise ValueError(f"{sub_clique} is not a subset of {clique}")
    out = p_coeff(domain, sub_clique)
    for j in set(clique) - set(sub_clique):
        out /= domain.attributes[j].size ** 2
    return out


def axis_coeff_vectors(domain: Domain
                       ) -> "tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]":
    """Per-attribute coefficient vectors ``(pcost, meas, marg, cross)`` for the
    arrayized planner IR (:mod:`repro_torch.core.plantable`).

    Thm 3/4 factor per axis: a clique's pcost coefficient is
    ``Π_{i∈A} (n_i−1)/n_i``; the coefficient of σ²_{A'} in the per-cell
    variance of the marginal on A is ``Π_{i∈A'} (n_i−1)/n_i ·
    Π_{i∈A∖A'} 1/n_i²``; the aligned-cell cross-marginal covariance adds a
    ``1/n_i`` factor for every axis in the symmetric difference A△B.
    """
    sizes = np.asarray(domain.sizes, dtype=np.float64)
    frac = (sizes - 1.0) / sizes
    return frac, frac, sizes ** -2.0, sizes ** -1.0
