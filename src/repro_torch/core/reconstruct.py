r"""Reconstruction phase (Algorithm 2) and closed-form variances (Theorem 4).

Reconstruction of the marginal on A uses only the noisy residual answers
ω_{A'} for A' ⊆ A.  The per-axis factors of U_{A←A'} are:

    Sub_{n_i}^†     for i ∈ A'          (Lemma 1 closed form)
    (1/n_i)·1       for i ∈ A \ A'      (column vector)
    [1]             for i ∉ A           (axis absent)

:func:`reconstruct_all_batched` is the device path: the subset answers of
each workload marginal are embedded on the host (numpy, as in the JAX
package) into disjoint slots of one (n_i)_{i∈A} tensor, a whole signature
group at a time (:func:`embed_group`), copied to the device once, run
through ONE merged chain ⊗ T_i, and copied back once.
``reconstruct_marginal`` and ``marginal_covariance_dense`` are the float64
host oracles.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.kron_matvec._layout import resolve_device

from .domain import Clique, Domain, subsets
from .kron import kron_matvec_batched, kron_matvec_np
from .mechanism import Measurement, signature_groups
from .residual import sub_pinv
from .select import Plan


def _u_factors(domain: Domain, clique: Clique, sub_clique: Clique):
    """Per-axis factors and input dims of U_{A←A'} restricted to A's axes."""
    sc = set(sub_clique)
    factors, in_dims = [], []
    for i in clique:
        n = domain.attributes[i].size
        if i in sc:
            factors.append(sub_pinv(n))
            in_dims.append(n - 1)
        else:
            factors.append(np.full((n, 1), 1.0 / n))
            in_dims.append(1)
    return factors, in_dims


def u_chain_factors(domain: Domain, clique: Clique) -> List[np.ndarray]:
    """Per-axis factors T_i = [ Sub_{n_i}^† | (1/n_i)·1 ]  (n_i × n_i).

    For every A' ⊆ A, U_{A←A'} ω_{A'} equals (⊗_{i∈A} T_i) e_{A'}, where
    e_{A'} embeds ω_{A'} into the (n_i)_{i∈A} tensor at axis-i slots
    0..n_i-2 when i ∈ A' and slot n_i-1 otherwise.  Distinct subsets occupy
    *disjoint* slot regions, so Algorithm 2's sum over 2^|A| subset matvecs
    collapses to ONE Kronecker chain applied to the sum of embeddings.
    """
    out = []
    for i in clique:
        n = domain.attributes[i].size
        out.append(np.hstack([sub_pinv(n), np.full((n, 1), 1.0 / n)]))
    return out


def subset_slot_region(clique: Clique, sub_clique: Clique,
                       slot_dims: Sequence[int]):
    """(region, shape) of subset A' in the merged-chain slot tensor.

    Axis i has ``slot_dims[i]`` slots: the measured part occupies slots
    ``0..slot_dims[i]−2`` when i ∈ A', the marginalized part the single last
    slot otherwise.  Distinct subsets occupy disjoint regions.
    """
    sc = set(sub_clique)
    region = tuple(slice(0, r - 1) if i in sc else slice(r - 1, r)
                   for i, r in zip(clique, slot_dims))
    shape = tuple(r - 1 if i in sc else 1 for i, r in zip(clique, slot_dims))
    return region, shape


def embed_subset_answers(plan: Plan, measurements: Mapping[Clique, Measurement],
                         clique: Clique, dtype=np.float64) -> np.ndarray:
    """Sum of subset embeddings Σ_{A'⊆A} e_{A'} — input of the merged U-chain."""
    sizes = plan.domain.clique_sizes(clique)
    t = np.zeros(sizes, dtype=dtype)
    for sub in subsets(clique):
        region, shape = subset_slot_region(clique, sub, sizes)
        t[region] = np.asarray(measurements[sub].omega, dtype=dtype).reshape(shape)
    return t


def embed_group(plan: Plan, measurements: Mapping[Clique, Measurement],
                group: Sequence[Clique], dtype=np.float32) -> np.ndarray:
    """(g, Π n_i) stack of :func:`embed_subset_answers` for a signature group.

    Same-signature cliques share every slot region, so each of the 2^k
    subset positions fills its region for the whole group with one stacked
    copy instead of one small copy per clique.
    """
    sizes = plan.domain.clique_sizes(group[0])
    g, k = len(group), len(sizes)
    x = np.zeros((g,) + tuple(sizes), dtype=dtype)
    pos = tuple(range(k))
    for sub_pos in subsets(pos):
        region, shape = subset_slot_region(pos, sub_pos, sizes)
        x[(slice(None),) + region] = np.stack(
            [measurements[tuple(c[j] for j in sub_pos)].omega for c in group]
        ).reshape((g,) + shape)
    return x.reshape(g, -1)


def reconstruct_marginal(plan: Plan, measurements: Mapping[Clique, Measurement],
                         clique: Clique) -> np.ndarray:
    """Unbiased noisy answer to the marginal on ``clique`` (Algorithm 2),
    float64 on the host: one subset matvec per A' ⊆ A."""
    n_cells = plan.domain.n_cells(clique)
    q = None
    for sub in subsets(clique):
        omega = measurements[sub].omega
        if not clique:
            term = np.asarray(omega, dtype=float).reshape(-1)
        else:
            factors, in_dims = _u_factors(plan.domain, clique, sub)
            term = kron_matvec_np(factors, np.asarray(omega).reshape(-1), in_dims)
        q = term if q is None else q + term
    if q is None or q.shape[0] != n_cells:
        raise ValueError(f"reconstruction of {clique} has the wrong size")
    return q


def reconstruct_all(plan: Plan, measurements: Mapping[Clique, Measurement]
                    ) -> Dict[Clique, np.ndarray]:
    return {c: reconstruct_marginal(plan, measurements, c)
            for c in plan.workload.cliques}


def reconstruct_all_batched(plan: Plan, measurements: Mapping[Clique, Measurement],
                            cliques: Optional[Sequence[Clique]] = None,
                            use_kernel: bool = True,
                            device=None) -> Dict[Clique, np.ndarray]:
    """Batched Algorithm 2: same-signature marginals share one kernel chain.

    Marginals are grouped by attribute-size signature (they share the merged
    U-chain ⊗ T_i exactly), their embedded subset-answer tensors are stacked
    into the batch axis, and each group runs as a single chain: the fused
    kernel (or its per-axis fallback) when ``use_kernel``, the plain batched
    torch path otherwise.  Returns float32 host arrays.
    """
    dev = resolve_device(device)
    cliques = list(plan.workload.cliques if cliques is None else cliques)
    out: Dict[Clique, np.ndarray] = {}
    for sizes, group in signature_groups(plan.domain, cliques).items():
        if not sizes:
            for c in group:
                out[c] = np.asarray(measurements[()].omega, dtype=float).reshape(-1)
            continue
        xt = torch.from_numpy(embed_group(plan, measurements, group)).to(dev)
        factors = u_chain_factors(plan.domain, group[0])
        if use_kernel:
            from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec
            y = fused_chain_matvec(factors, xt, sizes)
        else:
            y = kron_matvec_batched(factors, xt, sizes)
        y = y.cpu().numpy()
        for i, c in enumerate(group):
            out[c] = y[i]
    return out


def marginal_variance(plan: Plan, clique: Clique) -> float:
    """Per-cell variance of the reconstructed marginal (Theorem 4) — all cells equal."""
    return plan.marginal_variance(clique)


def marginal_covariance_dense(plan: Plan, clique: Clique) -> np.ndarray:
    """Full covariance matrix of the reconstructed marginal on ``clique``.

    Cov = Σ_{A'⊆A} σ²_{A'} · ⊗_{i∈A} G_i   with
        G_i = Sub† (Sub Subᵀ) Sub†ᵀ   for i ∈ A'
        G_i = (1/n²) 11ᵀ              for i ∈ A \\ A'

    Materializes the n_cells × n_cells matrix — small cliques only.
    """
    from .kron import kron_expand
    from .residual import sub_gram

    dom = plan.domain
    n = dom.n_cells(clique)
    cov = np.zeros((n, n))
    for sub in subsets(clique):
        facs = []
        for i in clique:
            sz = dom.attributes[i].size
            if i in set(sub):
                sp = sub_pinv(sz)
                facs.append(sp @ sub_gram(sz) @ sp.T)
            else:
                facs.append(np.full((sz, sz), 1.0 / sz ** 2))
        cov += plan.sigmas[sub] * (kron_expand(facs) if facs else np.ones((1, 1)))
    return cov
