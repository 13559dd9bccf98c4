"""The plain reference of a marginal release (ResidualPlanner+, Algorithms 1
and 2 with the Lemma 2 plan), in plain PyTorch, float64 by default.

It imports nothing of the program and takes nothing the program made: the
closure, the noise scales σ²_A, the residual answers ω_A and the workload
tables are worked out again here from the domain sizes, the workload, the
budget, the exact marginal tables and the release's seed.

* Plan (Lemma 2, sum of variances): p_A = Π_{i∈A} (n_i − 1)/n_i and
  v_A = Σ_{W ⊇ A} p_A Π_{j ∈ W∖A} 1/n_j² over the workload W; then
  σ²_A = (Σ_B √(p_B v_B)) / c · √(p_A / v_A) at pcost budget c.
* Measure (Algorithm 1): ω_A = H_A v_A + σ_A H_A z_A with
  H_A = ⊗_{i∈A} Sub_{n_i}, Sub_n the (n−1) × n matrix with first column 1
  and −1 at (i, i+1); z is ONE standard normal draw of Σ_A |cells(A)|
  float32 values from ``torch.Generator(device).manual_seed(seed)``, laid
  out clique after clique in closure order.
* Reconstruct (Algorithm 2): the table on A is
  Σ_{B⊆A} (⊗_{i∈A} U_i) ω_B with U_i = Sub_{n_i}^† (n_i × (n_i − 1),
  (1/n)[1ᵀ; 11ᵀ − nI]) for i ∈ B and (1/n_i)·1 for i ∈ A∖B.

Every function works on signature groups (cliques of one tuple of sizes)
as stacked tensors; ``dtype`` is the arithmetic type (a lower one serves as
the control).
"""
from __future__ import annotations

import itertools
import math
from collections import defaultdict
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

Clique = Tuple[int, ...]


def subsets(clique: Clique) -> List[Clique]:
    return [s for r in range(len(clique) + 1)
            for s in itertools.combinations(clique, r)]


def closure(workload: Sequence[Clique]) -> List[Clique]:
    seen = set()
    for c in workload:
        seen.update(subsets(tuple(c)))
    return sorted(seen, key=lambda c: (len(c), c))


def clique_keys(mat: np.ndarray, n_attrs: int) -> np.ndarray:
    """One integer per row of a (cliques, width) matrix: the attributes
    plus one as digits in base n_attrs + 1 (the empty clique is 0)."""
    key = np.zeros(len(mat), np.int64)
    for j in range(mat.shape[1]):
        key = key * (n_attrs + 1) + (mat[:, j] + 1)
    return key


def by_width(cliques: Sequence[Clique]) -> Dict[int, np.ndarray]:
    rows: Dict[int, list] = defaultdict(list)
    for c in cliques:
        rows[len(c)].append(c)
    return {w: np.asarray(r, np.int64).reshape(len(r), w)
            for w, r in rows.items()}


def sov_sigma2(sizes: Sequence[int], workload: Sequence[Clique],
               budget: float, dtype=np.float64) -> Tuple[List[Clique], np.ndarray]:
    """(closure, σ² of each closure clique) of the Lemma 2 plan."""
    cl = closure(workload)
    d = len(sizes)
    n = np.asarray(sizes, np.float64)
    frac, inv2 = ((n - 1) / n).astype(dtype), (1.0 / n ** 2).astype(dtype)
    keys = np.concatenate([clique_keys(m, d) for m in by_width(cl).values()])
    order = np.argsort(keys)

    def index(mat):
        return order[np.searchsorted(keys[order], clique_keys(mat, d))]

    p = np.ones(len(cl), dtype)
    for mat in by_width(cl).values():
        p[index(mat)] = frac[mat].prod(axis=1, dtype=dtype)
    v = np.zeros(len(cl), dtype)
    for w, mat in by_width(workload).items():
        for pos in subsets(tuple(range(w))):
            rest = [j for j in range(w) if j not in pos]
            idx = index(mat[:, list(pos)])
            np.add.at(v, idx, p[idx] * inv2[mat[:, rest]].prod(axis=1, dtype=dtype))
    if not np.all(v > 0):
        raise ValueError("a closure clique has no weight in the workload")
    s = np.sqrt(p * v).sum(dtype=dtype)
    return cl, (s / dtype(budget)) * np.sqrt(p / v)


def sub_matrix(n: int, dtype, device) -> torch.Tensor:
    s = torch.zeros((n - 1, n), dtype=dtype, device=device)
    s[:, 0] = 1
    s[torch.arange(n - 1), torch.arange(1, n)] = -1
    return s


def sub_pinv(n: int, dtype, device) -> torch.Tensor:
    top = torch.ones((1, n - 1), dtype=torch.float64)
    bot = torch.ones((n - 1, n - 1), dtype=torch.float64) \
        - n * torch.eye(n - 1, dtype=torch.float64)
    return (torch.cat([top, bot]) / n).to(device=device, dtype=dtype)


def apply_chain(x: torch.Tensor, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """(g, *in) → (g, *out): factor j applied along axis j + 1."""
    for j, f in enumerate(factors):
        x = torch.movedim(torch.tensordot(x, f, dims=([j + 1], [1])), -1, j + 1)
    return x


def noise_offsets(sizes: Sequence[int], cl: Sequence[Clique]) -> Dict[Clique, int]:
    offs, pos = {}, 0
    for c in cl:
        offs[c] = pos
        pos += math.prod(sizes[i] for i in c)
    return offs


def draw_noise(sizes, cl, seed: int, device) -> torch.Tensor:
    total = sum(math.prod(sizes[i] for i in c) for c in cl)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(total, generator=gen, device=device, dtype=torch.float32)


def by_signature(sizes, cliques: Sequence[Clique]) -> Dict[tuple, List[Clique]]:
    groups: Dict[tuple, List[Clique]] = defaultdict(list)
    for c in cliques:
        groups[tuple(sizes[i] for i in c)].append(c)
    return dict(groups)


def measure(sizes, cliques: Sequence[Clique], sigma2: Mapping[Clique, float],
            marginals: Mapping[Clique, np.ndarray], z: torch.Tensor,
            offsets: Mapping[Clique, int], device, dtype=torch.float64
            ) -> Dict[tuple, Tuple[List[Clique], torch.Tensor]]:
    """ω of each clique, by signature group: {dims: (cliques, (g, Π(n−1)))}."""
    out = {}
    for dims, group in by_signature(sizes, cliques).items():
        m = math.prod(dims)
        v = torch.from_numpy(np.stack([np.asarray(marginals[c], np.float64)
                                       .reshape(-1) for c in group]))
        v = v.to(device=device, dtype=dtype).reshape((len(group),) + dims)
        idx = torch.tensor([offsets[c] for c in group], device=device)
        zz = z[idx[:, None] + torch.arange(m, device=device)].to(dtype)
        zz = zz.reshape((len(group),) + dims)
        sig = torch.tensor([math.sqrt(sigma2[c]) for c in group],
                           dtype=torch.float64).to(device=device, dtype=dtype)
        factors = [sub_matrix(n, dtype, device) for n in dims]
        om = apply_chain(v, factors) + sig.reshape((-1,) + (1,) * len(dims)) \
            * apply_chain(zz, factors)
        out[dims] = (group, om.reshape(len(group), -1))
    return out


def reconstruct(sizes, cliques: Sequence[Clique],
                omega: Mapping[tuple, Tuple[List[Clique], torch.Tensor]],
                device, dtype=torch.float64
                ) -> Dict[tuple, Tuple[List[Clique], torch.Tensor]]:
    """Each table, by signature group: {dims: (cliques, (g, Π n))}, from the
    ω of every subset (``omega`` as :func:`measure` returns it)."""
    where = {}
    for dims, (group, om) in omega.items():
        for r, c in enumerate(group):
            where[c] = (dims, r)
    out = {}
    for dims, group in by_signature(sizes, cliques).items():
        k = len(dims)
        acc = torch.zeros((len(group),) + dims, dtype=dtype, device=device)
        for pos in subsets(tuple(range(k))):
            subs = [tuple(c[j] for j in pos) for c in group]
            sdims = where[subs[0]][0]
            rows = torch.tensor([where[b][1] for b in subs], device=device)
            w = omega[sdims][1].index_select(0, rows).to(dtype)
            in_dims = tuple(n - 1 if j in pos else 1 for j, n in enumerate(dims))
            w = w.reshape((len(group),) + in_dims)
            factors = [sub_pinv(n, dtype, device) if j in pos else
                       torch.full((n, 1), 1.0 / n, dtype=dtype, device=device)
                       for j, n in enumerate(dims)]
            acc = acc + apply_chain(w, factors)
        out[dims] = (group, acc.reshape(len(group), -1))
    return out
