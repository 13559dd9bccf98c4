r"""ReM-style local non-negativity for released marginals.

The port of ``repro.release.nonneg``.  Raw unbiased releases are frequently
negative in small cells; non-negativity is enforced *per marginal* — each
table is projected onto its own scaled simplex

    Δ_A(T) = { q ≥ 0 : Σ q = T }

with T the family's common total count, so the projection never touches the
contingency table.  Projections are signature-batched like the serving
engines: same-shape marginals stack into one sort-based projection (torch
on the device at the noise dtype, fp64 numpy on the host).

Per-marginal projection breaks mutual consistency; :func:`nonneg_release`
therefore runs consistency → projection, and optionally a multiplicative-
weights refinement loop over the workload cliques (:func:`mw_refine`).

Totals are preserved *exactly* in fp64 (the secure discrete path hands an
integer total down): after projection the residual rounding defect is folded
into the largest cell, so ``q.sum() == T`` to the last ulp.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.domain import Clique, Domain
from repro_torch.core.mechanism import noise_dtype, signature_groups
from repro_torch.core.plantable import BasePlan
from repro_torch.kernels.kron_matvec._layout import resolve_device

from .consistency import solve_consistency


def _simplex_rows_np(y: np.ndarray, total: np.ndarray) -> np.ndarray:
    """Euclidean projection of every row of ``y`` onto Δ(total_i), fp64.

    Sort-based: q = max(y − τ, 0) with τ from the largest prefix keeping the
    active set positive (Held–Wolfe–Crowder).  Rows with total ≤ 0 project to
    zero.
    """
    y = np.asarray(y, np.float64)
    total = np.asarray(total, np.float64)
    g, m = y.shape
    u = -np.sort(-y, axis=1)
    css = np.cumsum(u, axis=1)
    j = np.arange(1, m + 1)
    rho = np.sum(u * j > css - total[:, None], axis=1)
    rho = np.maximum(rho, 1)
    tau = (css[np.arange(g), rho - 1] - total) / rho
    q = np.maximum(y - tau[:, None], 0.0)
    return np.where(total[:, None] > 0, q, 0.0)


def _row_cumsum(u: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(u, dim=1)`` in an order fixed by the shapes.

    On CUDA a tensor that is one row takes a single-pass scan, whose
    look-back may follow the scheduling; a stack of two or more rows scans
    each row in a fixed order.  A lone row therefore scans beside a zero
    row."""
    if u.shape[0] == 1 and u.is_cuda:
        return torch.cumsum(torch.cat([u, torch.zeros_like(u)]), dim=1)[:1]
    return torch.cumsum(u, dim=1)


def _simplex_rows(y: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Torch twin of :func:`_simplex_rows_np` on ``y``'s device and dtype
    (the JAX package's ``_simplex_rows_jnp``): sort, cumsum, threshold,
    rows with total ≤ 0 → 0."""
    m = y.shape[1]
    u = torch.sort(y, dim=1, descending=True).values
    css = _row_cumsum(u)
    j = torch.arange(1, m + 1, dtype=y.dtype, device=y.device)
    rho = torch.clamp_min((u * j > css - total[:, None]).sum(dim=1), 1)
    tau = (torch.gather(css, 1, (rho - 1)[:, None])[:, 0] - total) / rho
    q = torch.clamp_min(y - tau[:, None], 0.0)
    return torch.where(total[:, None] > 0, q, torch.zeros_like(q))


def simplex_project_batch(y: np.ndarray, total, backend: str = "device",
                          device=None) -> np.ndarray:
    """Project a (g, m) stack of tables onto their scaled simplices.

    ``backend="device"`` projects on ``device`` (CUDA unless
    ``device="cpu"``) at the noise dtype, float32, as the JAX package's
    device twin does; ``"host"`` in fp64 numpy."""
    total = np.broadcast_to(np.asarray(total, np.float64), (y.shape[0],))
    if backend == "device":
        dev = resolve_device(device)
        yt = torch.as_tensor(np.asarray(y), dtype=noise_dtype(), device=dev)
        q = _simplex_rows(yt, torch.tensor(total, dtype=yt.dtype, device=dev))
        return q.cpu().numpy().astype(np.float64)
    if backend != "host":
        raise ValueError(f"backend must be 'device' or 'host', got {backend!r}")
    return _simplex_rows_np(y, total)


def _exact_total(q: np.ndarray, total: float) -> np.ndarray:
    """Fold the fp rounding defect back into the table: Σq == total.

    Iterates against the consumer's own reduction (``q.sum()``); when the
    defect drops below the largest cell's ulp it is folded into a smaller
    cell instead.  The fixed point Σq == total is reached in a pass or two
    in practice; the worst case is one ulp of the total — in particular
    integer totals always round-trip exactly through ``round(q.sum())``.
    """
    q = np.asarray(q, np.float64)
    if total <= 0:
        return np.zeros_like(q)
    i = int(np.argmax(q))
    for _ in range(16):
        d = total - float(q.sum())     # the same reduction consumers run
        if d == 0.0:
            break
        j, nq = i, max(q[i] + d, 0.0)
        if nq == q[i]:     # defect below this cell's ulp: use a smaller cell
            pos = np.nonzero((q > 0) & (np.spacing(q) <= abs(d)))[0]
            if len(pos) == 0:
                break
            j = int(pos[np.argmin(q[pos])])
            nq = max(q[j] + d, 0.0)
            if nq == q[j]:
                break
        q[j] = nq
    return q


def project_nonneg(domain: Domain, tables: Mapping[Clique, np.ndarray],
                   total: float, backend: str = "device",
                   exact_total: bool = True, device=None
                   ) -> Dict[Clique, np.ndarray]:
    """Local non-negativity: signature-batched per-marginal simplex projection.

    Purely local (does not restore consistency); the serving entry point is
    :func:`nonneg_release`.
    """
    cliques = list(tables.keys())
    out: Dict[Clique, np.ndarray] = {}
    for group in signature_groups(domain, cliques).values():
        y = np.stack([np.asarray(tables[c], np.float64).reshape(-1)
                      for c in group])
        q = simplex_project_batch(y, total, backend, device)
        for i, c in enumerate(group):
            out[c] = _exact_total(q[i], total) if exact_total else q[i]
    return out


def mw_refine(plan: BasePlan, tables: Dict[Clique, np.ndarray], total: float,
              rounds: int, eta: float = 0.5,
              weights: Optional[np.ndarray] = None,
              backend: str = "device", device=None,
              use_kernel: bool = True) -> Dict[Clique, np.ndarray]:
    """Multiplicative-weights refinement over the workload cliques.

    Each round re-fits the covariance-weighted consistent family to the
    current non-negative tables and takes an entropic step toward it:
    ``q ← q · exp(η (target − q)/s)`` rescaled back to total T — positive and
    total-preserving by construction, converging toward the intersection of
    the simplices with the consistent family.
    """
    if total <= 0 or rounds <= 0:
        return tables
    scale = max(total / max(np.mean([t.size for t in tables.values()]), 1.0),
                1e-12)
    q = {c: np.asarray(t, np.float64).copy() for c, t in tables.items()}
    floor = 1e-9 * scale
    for _ in range(rounds):
        cons = solve_consistency(plan, q, weights=weights, fix_total=total,
                                 backend=backend, device=device,
                                 use_kernel=use_kernel)
        target = cons.marginals()
        for c in q:
            cur = np.maximum(q[c], floor)
            step = np.clip(eta * (target[c] - cur) / scale, -40.0, 40.0)
            nxt = cur * np.exp(step)
            s = nxt.sum()
            q[c] = _exact_total(nxt * (total / s) if s > 0 else nxt, total)
    return q


def nonneg_release(plan: BasePlan, tables: Mapping[Clique, np.ndarray],
                   *, total: Optional[float] = None,
                   weights: Optional[np.ndarray] = None,
                   cell_weights: Optional[Mapping[Clique, np.ndarray]] = None,
                   mw_rounds: int = 0, eta: float = 0.5,
                   tol: float = 1e-9, maxiter: int = 200,
                   backend: str = "device",
                   cliques: Optional[Sequence[Clique]] = None,
                   device=None, use_kernel: bool = True
                   ) -> Dict[Clique, np.ndarray]:
    """Consistency → local non-negativity (→ optional MW refinement).

    The serving postprocessor behind ``engine.release(postprocess="nonneg")``:
    covariance-weighted consistent fit (CG on the residual coordinates,
    ``fix_total`` pinning when ``total`` is given — the secure path passes the
    measured *integer* total), then the signature-batched simplex projection,
    then ``mw_rounds`` rounds of multiplicative-weights refinement.  Every
    returned table is non-negative and sums to the common total to within
    one ulp (integer totals round-trip exactly through ``round``).
    ``device`` and ``use_kernel`` reach the device CG and projection.
    """
    cons = solve_consistency(plan, tables, weights=weights,
                             cell_weights=cell_weights, fix_total=total,
                             tol=tol, maxiter=maxiter, backend=backend,
                             device=device, use_kernel=use_kernel)
    t = float(total) if total is not None else cons.total
    t = max(t, 0.0)
    q = cons.marginals()       # full workload: MW re-fits need every marginal
    q = project_nonneg(plan.domain, q, t, backend=backend, device=device)
    if mw_rounds:
        q = mw_refine(plan, q, t, mw_rounds, eta, weights, backend, device,
                      use_kernel)
    if cliques is not None:
        q = {c: q[c] for c in cliques}
    return q
