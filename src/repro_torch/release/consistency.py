r"""Covariance-weighted consistency across overlapping noisy marginals.

The port of ``repro.release.consistency``.  Given noisy marginal tables
``y_A`` for the workload cliques, find the *mutually consistent* family
closest to them in the covariance-weighted least-squares sense.

**Parameterization.**  A family of marginals over the workload is mutually
consistent iff it is the image of residual coordinates: with
``T_i = [Sub_{n_i}^† | (1/n_i)·1]`` (the merged reconstruction factors of
``core/reconstruct.py``) and the slot embedding ``E_A`` that places each
``r_{A'}``, A' ⊆ A, into its disjoint slot region,

    q_A(r) = (⊗_{i∈A} T_i) · E_A · r .

So consistency is an *unconstrained* WLS over r — never over the
``Π n_i``-sized contingency table:

    min_r  Σ_{A∈W} w_A ‖ c_A ⊙ (q_A(r) − y_A) ‖²                       (*)

with per-marginal precision weights ``w_A = Imp_A / Var_A`` straight off the
PlanTable IR (Thm 4/8) and optional per-cell weights ``c_A``.

**Normal equations on the IR.**  M r = b with
``M = Σ_A w_A E_Aᵀ K_Aᵀ C_A K_A E_A``, ``K_A = ⊗T_i``.  The forward and
adjoint maps are signature-batched Kronecker chains over a gather index
``idx`` (g, Π n_i) per workload group.

**The Kron-factored preconditioner.**  ``Sub^†`` has zero column sums, so for
uniform per-cell weights M is block-diagonal over the closure:

    M_{A'} = α_{A'} · ⊗_{i∈A'} (Sub_i^†ᵀ Sub_i^†),
    α_{A'} = Σ_{A ⊇ A'} w_A · Π_{i∈A∖A'} 1/n_i ,

and the block-Jacobi preconditioner applies its exact inverse (batched
chains of the per-axis inverses ``G_i⁻¹``).

**On the device** (``backend="device"``) the three chain families — forward
⊗T_i, adjoint ⊗T_iᵀ and preconditioner ⊗G_i⁻¹ — run through
:func:`~repro_torch.kernels.kron_matvec.fused.fused_chain_matvec` (the fused
kernel, or the per-axis kernel for chains too wide for a block) when
``use_kernel``, and through the plain batched torch chain otherwise and on
the CPU.  The gather ``r[idx]`` is a torch index; the scatter back, where
many workload cliques add into one coordinate, is a
:class:`~repro_torch.core.segment.Segments` sum over every group at once,
whose order of addition is fixed by the data, and the preconditioner's
output (every coordinate in one closure group) is one permutation gather.
So two solves from the same tables are identical bit for bit.  The chains
run at the noise dtype (float32); ``rhs_np`` and the marginals stay host
fp64, so a consistent family is consistent to fp64 rounding whatever the
CG's precision.

:func:`dense_wls_oracle` materializes the design matrix and solves the
normal equations in fp64 — the small-domain reference of the tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.domain import Clique, subsets
from repro_torch.core.kron import (kron_expand, kron_matvec_batched,
                                   kron_matvec_np_batched)
from repro_torch.core.mechanism import noise_dtype, signature_groups
from repro_torch.core.plantable import BasePlan, _encode
from repro_torch.core.reconstruct import subset_slot_region, u_chain_factors
from repro_torch.core.residual import sub_pinv
from repro_torch.core.segment import Segments
from repro_torch.kernels.kron_matvec._layout import resolve_device


def precision_weights(plan: BasePlan) -> np.ndarray:
    """Per-marginal WLS weights w_A = Imp_A / Var_A from the IR (Thm 4/8).

    For plain tables ``Var_A`` is the per-cell variance; RP+ identity-basis
    tables report the Thm-8 SoV convention — any positive per-marginal
    weighting yields a valid consistent WLS fit, only the distribution of the
    disagreement across marginals changes.
    """
    var = np.asarray(plan.variances_array(), np.float64)
    imp = np.asarray(plan.workload.weight_array(), np.float64)
    return imp / np.maximum(var, 1e-300)


def _chain_np(factors: Sequence[np.ndarray], x: np.ndarray,
              dims: Sequence[int]) -> np.ndarray:
    """Batched host-fp64 Kronecker chain (B, Π dims) → (B, Π out)."""
    return kron_matvec_np_batched([np.asarray(f, np.float64) for f in factors],
                                  np.asarray(x, np.float64), dims)


@dataclass
class _WorkGroup:
    """One workload signature group of the WLS operator."""

    dims: Tuple[int, ...]
    cliques: List[Clique]
    idx: np.ndarray              # (g, Π n_i) flat-r index of every slot
    w: np.ndarray                # (g,) per-marginal precision weights
    cw: Optional[np.ndarray]     # (g, Π n_i) per-cell weights, or None
    factors: List[np.ndarray]    # T_i per axis


@dataclass
class _ClosureGroup:
    """One closure signature group of the block-Jacobi preconditioner."""

    rdims: Tuple[int, ...]       # per-axis residual sizes n_i − 1
    ridx: np.ndarray             # (g, Π rdims) flat-r index of every coord
    alpha: np.ndarray            # (g,) block scalars α_{A'}
    ginv: List[np.ndarray]       # (Sub†ᵀSub†)⁻¹ per axis


class _ClosureLookup:
    """Closure position of sub-cliques given as (g, s) attribute matrices.

    Uses the table's per-size member matrices (sorted keys, one
    ``searchsorted``) when it has them, its clique index otherwise."""

    def __init__(self, table):
        self.table = table
        self.base = max(table.domain.n_attrs, 2)
        self.keys: Dict[int, np.ndarray] = {}

    def __call__(self, subs: np.ndarray) -> np.ndarray:
        t = self.table
        s = subs.shape[1]
        if t._members is None:
            return np.fromiter((t.index[tuple(int(a) for a in row)]
                                for row in subs), np.int64, count=len(subs))
        keys = self.keys.get(s)
        if keys is None:
            keys = self.keys[s] = _encode(t._members[s], self.base)
        want = _encode(subs, self.base)
        pos = np.searchsorted(keys, want)
        if not np.array_equal(keys[np.minimum(pos, len(keys) - 1)], want):
            raise ValueError("a sub-clique is missing from the plan's closure")
        return t._offsets[s] + pos


def _slot_patterns(dims: Tuple[int, ...]):
    """For each subset of the k positions: (positions, flat slot indices of
    its region in C order, residual size).  ``idx[:, flat] = off + arange``
    places a subset's residual block as the JAX package's ``_slot_index``
    does, for a whole group at once."""
    k = len(dims)
    pos_all = tuple(range(k))
    slots = np.arange(math.prod(dims), dtype=np.int64).reshape(dims)
    out = []
    for sub in subsets(pos_all):
        region, _shape = subset_slot_region(pos_all, sub, dims)
        flat = slots[region].reshape(-1)
        out.append((sub, flat, int(flat.size)))
    return out


class ConsistencyOperator:
    """The WLS normal-equations operator M (and rhs/preconditioner) of (*).

    Built once per (plan, weights); ``solve_consistency`` runs the
    preconditioned CG on a torch device (batched chains on the kernels or
    the plain torch chain) or on the host in fp64.
    """

    def __init__(self, plan: BasePlan, weights: Optional[np.ndarray] = None,
                 cell_weights: Optional[Mapping[Clique, np.ndarray]] = None):
        self.plan = plan
        dom = plan.domain
        wk = list(plan.workload.cliques)
        w = precision_weights(plan) if weights is None \
            else np.asarray(weights, np.float64)
        if w.shape != (len(wk),):
            raise ValueError(f"weights must have shape ({len(wk)},)")
        if not np.all(w > 0):
            raise ValueError("precision weights must be strictly positive")
        self.weights = w
        # flat residual-coordinate layout over the closure
        closure = plan.cliques
        rsizes = np.fromiter((dom.residual_size(c) for c in closure), np.int64,
                             count=len(closure))
        self._off = np.concatenate([[0], np.cumsum(rsizes)[:-1]]).astype(np.int64)
        self.offsets: Dict[Clique, int] = dict(zip(closure,
                                                   self._off.tolist()))
        self.n_coords = int(rsizes.sum())
        self._lookup = _ClosureLookup(plan.table)
        wpos = {c: i for i, c in enumerate(wk)}
        alpha_at, alpha_val = [], []
        self.groups: List[_WorkGroup] = []
        for dims, cliques in signature_groups(dom, wk).items():
            gw = w[[wpos[c] for c in cliques]]
            idx, subs_pos = self._group_index(dims, cliques)
            for (sub, _flat, _rsz), pos in zip(_slot_patterns(dims), subs_pos):
                rest = [j for j in range(len(dims)) if j not in sub]
                alpha_at.append(pos)
                alpha_val.append(gw * math.prod(1.0 / dims[j] for j in rest))
            cw = None
            if cell_weights:
                cw = np.ones_like(idx, np.float64)
                for i, c in enumerate(cliques):
                    if c in cell_weights:
                        cw[i] = np.asarray(cell_weights[c],
                                           np.float64).reshape(-1)
                if not np.all(cw >= 0):
                    raise ValueError("cell weights must be non-negative")
            self.groups.append(_WorkGroup(
                dims, list(cliques), idx, gw, cw,
                u_chain_factors(dom, cliques[0]) if dims else []))
        # block-Jacobi: α_{A'} over the closure + per-axis Gram inverses
        alpha = np.bincount(np.concatenate(alpha_at),
                            weights=np.concatenate(alpha_val),
                            minlength=len(closure))
        cpos = plan.table.index
        self.pregroups: List[_ClosureGroup] = []
        for dims, cliques in signature_groups(dom, closure).items():
            rdims = tuple(n - 1 for n in dims)
            rsz = math.prod(rdims)
            at = np.fromiter((cpos[c] for c in cliques), np.int64,
                             count=len(cliques))
            ridx = self._off[at][:, None] + np.arange(rsz, dtype=np.int64)
            ginv = [np.linalg.inv(sub_pinv(n).T @ sub_pinv(n)) for n in dims]
            self.pregroups.append(_ClosureGroup(rdims, ridx, alpha[at], ginv))
        self._device: dict = {}

    def _group_index(self, dims: Tuple[int, ...], cliques: Sequence[Clique]
                     ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """(idx, positions): the (g, Π n_i) flat-r index of every slot of
        every clique of a signature group, and per subset pattern the
        closure positions of the cliques' sub-cliques.  One pattern per
        signature plus per-subset offsets, vectorised over the group."""
        g, k = len(cliques), len(dims)
        mat = np.asarray(cliques, np.int64).reshape(g, k)
        idx = np.empty((g, max(math.prod(dims), 1)), np.int64)
        positions = []
        for sub, flat, rsz in _slot_patterns(dims):
            pos = self._lookup(mat[:, list(sub)])
            idx[:, flat] = self._off[pos][:, None] + np.arange(rsz,
                                                               dtype=np.int64)
            positions.append(pos)
        return idx, positions

    def _slot_index(self, clique: Clique) -> np.ndarray:
        """Flat-r index of every slot position of ``clique``'s merged tensor."""
        dims = self.plan.domain.clique_sizes(clique)
        return self._group_index(dims, [clique])[0][0]

    # ------------------------------------------------------------- host fp64
    # The adjoint's scatter is one ``np.bincount`` over every group's slots
    # (the JAX package runs one per group, each over all n_coords: at
    # Adult's 254 groups that pass dominates the host CG).
    @cached_property
    def _flat_idx(self) -> np.ndarray:
        """Every group's slot index, flat, in group order."""
        return np.concatenate([g.idx.ravel() for g in self.groups])

    def _adjoint_np(self, weighted: Sequence[np.ndarray]) -> np.ndarray:
        """Σ_A E_Aᵀ K_Aᵀ s_A for per-group stacks ``s`` (already weighted)."""
        backs = [_chain_np([f.T for f in g.factors], s, g.dims).ravel()
                 for g, s in zip(self.groups, weighted)]
        return np.bincount(self._flat_idx, weights=np.concatenate(backs),
                           minlength=self.n_coords)

    def _weigh(self, g: _WorkGroup, y: np.ndarray) -> np.ndarray:
        s = g.w[:, None] * y
        return s * g.cw if g.cw is not None else s

    def matvec_np(self, r: np.ndarray) -> np.ndarray:
        return self._adjoint_np([
            self._weigh(g, _chain_np(g.factors, r[g.idx], g.dims))
            for g in self.groups])

    def rhs_np(self, tables: Mapping[Clique, np.ndarray]) -> np.ndarray:
        return self._adjoint_np([
            self._weigh(g, np.stack([np.asarray(tables[c], np.float64)
                                     .reshape(-1) for c in g.cliques]))
            for g in self.groups])

    def precond_np(self, s: np.ndarray) -> np.ndarray:
        """Block-Jacobi: every coordinate lies in one closure group, so each
        group's block is written, not added."""
        out = np.empty(self.n_coords)
        for g in self.pregroups:
            out[g.ridx] = _chain_np(g.ginv, s[g.ridx], g.rdims) \
                / g.alpha[:, None]
        return out

    # ---------------------------------------------------------------- device
    def device_fns(self, dtype, device, use_kernel: bool):
        """(matvec, precond) on ``device`` at ``dtype``, cached per
        (dtype, device, use_kernel).

        ``use_kernel`` runs every chain through ``fused_chain_matvec`` (the
        fused kernel, the per-axis kernel for chains over a block; on a CPU
        tensor their plain versions); the kernels are float32, so it needs
        ``dtype`` float32.  Otherwise the plain batched torch chain runs at
        ``dtype``."""
        dev = resolve_device(device)
        if use_kernel and dtype != torch.float32:
            raise ValueError("the chain kernels are float32; pass "
                             "use_kernel=False for another dtype")
        key = (str(dtype), str(dev), bool(use_kernel))
        ent = self._device.get(key)
        if ent is not None:
            return ent
        if use_kernel:
            from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec

            def chain(facs, x, dims):
                return fused_chain_matvec(facs, x, dims) if dims else x
        else:
            def chain(facs, x, dims):
                return kron_matvec_batched(facs, x, dims) if dims else x

        def as_dev(a, dt=None):
            return torch.as_tensor(a, dtype=dt, device=dev)

        def tensors(facs):
            return facs if use_kernel else [as_dev(f, dtype) for f in facs]

        # The groups' slot indices in one flat tensor: each group's idx is a
        # view of it, and the scatter back sums over all of them at once.
        flat = as_dev(self._flat_idx)
        scatter = Segments(flat, self.n_coords)
        wg, at = [], 0
        for g in self.groups:
            size = g.idx.size
            wg.append((tuple(g.dims), flat[at:at + size].view(g.idx.shape),
                       as_dev(g.w, dtype)[:, None],
                       None if g.cw is None else as_dev(g.cw, dtype),
                       tensors(g.factors),
                       tensors([np.ascontiguousarray(f.T) for f in g.factors])))
            at += size
        pg = [(tuple(g.rdims), as_dev(g.ridx), as_dev(g.alpha, dtype)[:, None],
               tensors(g.ginv)) for g in self.pregroups]
        # Every coordinate lies in exactly one closure group: the
        # preconditioner's output is one permutation of its groups' outputs.
        inv = np.empty(self.n_coords, np.int64)
        inv[np.concatenate([g.ridx.ravel() for g in self.pregroups])] = \
            np.arange(self.n_coords)
        inv = as_dev(inv)

        def matvec(r):
            backs = []
            for dims, idx, w, cw, facs, facs_t in wg:
                s = w * chain(facs, r[idx], dims)
                if cw is not None:
                    s = s * cw
                backs.append(chain(facs_t, s, dims).to(r.dtype))
            return scatter.sum_cat(backs)

        def precond(s):
            zs = [(chain(ginv, s[ridx], rdims) / alpha).to(s.dtype)
                  for rdims, ridx, alpha, ginv in pg]
            return torch.cat([z.reshape(-1) for z in zs])[inv]

        ent = (matvec, precond)
        self._device[key] = ent
        return ent

    # -------------------------------------------------------------- marginals
    def marginals_np(self, r: np.ndarray,
                     cliques: Optional[Sequence[Clique]] = None
                     ) -> Dict[Clique, np.ndarray]:
        """q_A(r) for the workload cliques (or any cliques in the closure)."""
        out: Dict[Clique, np.ndarray] = {}
        if cliques is None:
            for g in self.groups:
                q = _chain_np(g.factors, r[g.idx], g.dims)
                for i, c in enumerate(g.cliques):
                    out[c] = q[i]
            return out
        dom = self.plan.domain
        for c in cliques:
            idx = self._slot_index(c)
            q = _chain_np(u_chain_factors(dom, c) if c else [],
                          r[idx][None, :], dom.clique_sizes(c))
            out[c] = q[0]
        return out


@dataclass
class ConsistentRelease:
    """A consistent family of marginals: residual coordinates + provenance."""

    operator: ConsistencyOperator = field(repr=False)
    r: np.ndarray                # (n_coords,) fitted residual coordinates
    iterations: int
    rel_residual: float          # ‖Mr − b‖ / ‖b‖ at exit

    @property
    def plan(self) -> BasePlan:
        return self.operator.plan

    @property
    def total(self) -> float:
        """The common total count of every marginal in the family."""
        return float(self.r[self.operator.offsets[()]])

    def marginals(self, cliques: Optional[Sequence[Clique]] = None
                  ) -> Dict[Clique, np.ndarray]:
        return self.operator.marginals_np(self.r, cliques)

    def marginal(self, clique: Clique) -> np.ndarray:
        return self.operator.marginals_np(self.r, [clique])[clique]


def solve_consistency(plan: BasePlan, tables: Mapping[Clique, np.ndarray],
                      *, weights: Optional[np.ndarray] = None,
                      cell_weights: Optional[Mapping[Clique, np.ndarray]] = None,
                      fix_total: Optional[float] = None,
                      tol: float = 1e-9, maxiter: int = 200,
                      backend: str = "device", dtype=None,
                      operator: Optional[ConsistencyOperator] = None,
                      device=None, use_kernel: bool = True
                      ) -> ConsistentRelease:
    """Preconditioned-CG solve of the consistency WLS (*).

    ``backend="device"`` runs the batched chains on ``device`` (CUDA unless
    ``device="cpu"``) at ``dtype`` (default
    :func:`repro_torch.core.mechanism.noise_dtype`, float32), on the
    kernels when ``use_kernel`` (:meth:`ConsistencyOperator.device_fns`);
    ``"host"`` runs the same operator in numpy fp64.  ``fix_total`` pins the
    empty-clique coordinate — the family's common total — to an exact value
    (the secure path passes the measured integer total here); the CG then
    solves the reduced system in the complementary subspace.

    The stopping rules are the JAX package's: stop at ``rel ≤ tol``, at a
    non-positive curvature ``pᵀAp ≤ 0``, or after ``maxiter`` iterations.
    A float32 CG seldom reaches the default ``tol=1e-9``; it then runs on
    until one of the other two, and ``iterations`` says how far.
    """
    op = ConsistencyOperator(plan, weights, cell_weights) \
        if operator is None else operator
    if backend == "host":
        mv, pc = op.matvec_np, op.precond_np
        b = op.rhs_np(tables)

        def dot(a, c):
            return float(np.vdot(a, c))

        def const(a):
            return a
    elif backend == "device":
        dtype = noise_dtype() if dtype is None else dtype
        dev = resolve_device(device)
        mv, pc = op.device_fns(dtype, dev, use_kernel)

        def const(a):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        def dot(a, c):
            return float(torch.dot(a, c))
        b = const(op.rhs_np(tables))
    else:
        raise ValueError(f"backend must be 'device' or 'host', got {backend!r}")

    e0 = op.offsets[()]
    if fix_total is not None:
        # Pin r_∅ = t0 and solve the reduced system in the complement: every
        # CG direction is masked at e0, the pinned coordinate enters via b.
        t0 = float(fix_total)
        mask_np = np.ones(op.n_coords)
        mask_np[e0] = 0.0
        unit_np = np.zeros(op.n_coords)
        unit_np[e0] = t0
        mask, unit = const(mask_np), const(unit_np)
        b = mask * (b - mv(unit))
        x = unit

        def amv(p):
            return mask * mv(mask * p)

        def apc(s):
            return mask * pc(mask * s)
    else:
        x = const(np.zeros(op.n_coords))
        amv, apc = mv, pc

    def host(v):
        return np.asarray(v.cpu().double() if torch.is_tensor(v) else v,
                          np.float64)

    bnorm = math.sqrt(dot(b, b))
    if bnorm == 0.0:
        return ConsistentRelease(op, host(x), 0, 0.0)
    resid = b       # the CG correction starts at zero in both branches
    z = apc(resid)
    p = z
    rz = dot(resid, z)
    it = 0
    rel = 1.0
    for it in range(1, maxiter + 1):  # noqa: B007 - it is reported after the loop
        ap = amv(p)
        pap = dot(p, ap)
        if pap <= 0:
            break
        step = rz / pap
        x = x + step * p
        resid = resid - step * ap
        rel = math.sqrt(dot(resid, resid)) / bnorm
        if rel <= tol:
            break
        z = apc(resid)
        rz_new = dot(resid, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return ConsistentRelease(op, host(x), it, rel)


def dense_wls_oracle(plan: BasePlan, tables: Mapping[Clique, np.ndarray],
                     *, weights: Optional[np.ndarray] = None,
                     cell_weights: Optional[Mapping[Clique, np.ndarray]] = None,
                     fix_total: Optional[float] = None) -> ConsistentRelease:
    """fp64 dense WLS reference: materialize the design, solve the normal
    equations with LAPACK.  Small domains only (design is Σ|cells| × n_coords)."""
    op = ConsistencyOperator(plan, weights, cell_weights)
    dom = plan.domain
    wk = list(plan.workload.cliques)
    w = op.weights
    rows = sum(dom.n_cells(c) for c in wk)
    design = np.zeros((rows, op.n_coords))
    wrow = np.empty(rows)
    y = np.empty(rows)
    r0 = 0
    cellw = dict(cell_weights) if cell_weights else {}
    for wi, c in enumerate(wk):
        m = dom.n_cells(c)
        k = kron_expand(u_chain_factors(dom, c)) if c else np.ones((1, 1))
        design[r0:r0 + m, op._slot_index(c)] = k
        cw = np.asarray(cellw[c], np.float64).reshape(-1) if c in cellw \
            else np.ones(m)
        wrow[r0:r0 + m] = w[wi] * cw
        y[r0:r0 + m] = np.asarray(tables[c], np.float64).reshape(-1)
        r0 += m
    m_mat = design.T @ (wrow[:, None] * design)
    b = design.T @ (wrow * y)
    e0 = op.offsets[()]
    if fix_total is not None:
        free = np.ones(op.n_coords, bool)
        free[e0] = False
        r = np.empty(op.n_coords)
        r[e0] = float(fix_total)
        r[free] = np.linalg.solve(
            m_mat[np.ix_(free, free)],
            b[free] - m_mat[free, e0] * float(fix_total))
    else:
        r = np.linalg.solve(m_mat, b)
    resid = m_mat @ r - b
    bn = float(np.linalg.norm(b)) or 1.0
    return ConsistentRelease(op, r, 0, float(np.linalg.norm(resid)) / bn)
