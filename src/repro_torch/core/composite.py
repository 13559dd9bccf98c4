r"""Divide-and-conquer selection: per-block plans stitched into one plan.

The port's copy of ``repro.core.composite`` (host numpy, float64): the same
blocks, allocation and σ² as the JAX package.  The per-block selectors are
the port's: max-variance runs on whatever backend its own ``backend="auto"``
picks (``device=`` forwarded), and :meth:`CompositePlan.engine` returns the
port's :class:`~repro_torch.engine.composite.CompositeEngine`.

``select_dnc`` is the planning route behind ``strategy="dnc"`` (and the
``"auto"`` overflow route) of the select entry points (docs/DESIGN.md §12):

1. partition the attributes from the workload's clique-interaction graph
   (:mod:`repro_torch.core.partition`);
2. build one PlanTable per block — each a few hundred closure cliques even
   when the monolithic closure would hold millions — and run the existing
   selector on it unchanged (maxvar dual ascent warm-starts each block from
   the previous same-shaped block's dual point);
3. allocate the privacy budget across blocks: one *unified* Lemma-2 closed
   form for SoV (exactly the monolithic optimum when no clique straddles a
   cut), bisection on the per-block value function for maxvar/convex;
4. return a :class:`CompositePlan` that answers the whole plan protocol by
   delegating to its block plans.

The **shared empty clique** is the one coupling between blocks: every block
closure contains ∅ (the noisy total), the composite measures it ONCE, and its
σ²_∅ is optimized jointly — for SoV by concatenating the per-block (p, v)
arrays with ``v_∅ = Σ_b v_b[∅]`` into a single closed form, for maxvar/convex
by an ∅-repair step (pin σ²_∅ to the tightest block's choice, then rescale so
pcost is tight again; both steps only ever lower variances).  Because ∅ is
shared, reconstructed marginals in *different* blocks are not independent:
their aligned-cell covariance is exactly ``σ²_∅ · Π_{i∈A∪B} 1/n_i`` — the
monolithic Thm-4 value — which is what makes disjoint-block D&C *exact*, not
merely close.  (The covariance across blocks would be zero only if each
block bought its own total; the shared total is kept and its exact
covariance reported — documented in DESIGN.md §12.)

Cliques that straddle a cut are answered by the *product-of-blocks
correction* (:mod:`repro_torch.core.partition`): the marginal is the normalized
outer product of its per-block projections, and ``variances_array`` reports
the independence-proxy variance
``Var_A ≈ Σ_p Var_p · Π_{p'≠p} n_cells(p')^{-2}`` (exact for one part,
heuristic otherwise — the total-count factors cancel when every other part's
cell mass is spread uniformly).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .domain import Clique, Domain, MarginalWorkload
from .partition import (DEFAULT_MAX_BLOCK, Decomposition, Partition,
                        ROW_EMPTY, decompose, partition_attributes)
from .plantable import BasePlan, PlanTable, plan_table, sov_closed_form


# ---------------------------------------------------------------------------
# Cross-block budget allocation
# ---------------------------------------------------------------------------

def allocate_budget(values: np.ndarray, budget: float,
                    combine: str = "max") -> np.ndarray:
    """Split ``budget`` across blocks given unit-budget block losses V_b.

    Every selector loss is positively 1-homogeneous in σ² and pcost is
    (−1)-homogeneous, so a block planned at unit budget rescales exactly:
    at budget c_b its loss is V_b / c_b.  The allocator solves

    * ``combine="max"``:  min max_b V_b/c_b   s.t. Σ c_b = budget
    * ``combine="sum"``:  min Σ_b V_b/c_b     s.t. Σ c_b = budget

    by bisection on the dual multiplier λ (c_b(λ) = V_b/λ resp. √(V_b/λ);
    Σ c_b(λ) is strictly decreasing in λ), then normalizes so the budget is
    met exactly.  Blocks with V_b = 0 (degenerate, nothing to lose) get a
    vanishing sliver.
    """
    V = np.asarray(values, np.float64)
    c = float(budget)
    if not c > 0:
        raise ValueError(f"pcost budget must be positive, got {c}")
    if (V < 0).any():
        raise ValueError("block losses must be non-negative")
    pos = V > 0
    if not pos.any():
        return np.full(len(V), c / max(len(V), 1))
    Vp = np.where(pos, V, V[pos].min() * 1e-12)

    def total(lam: float) -> float:
        return float((Vp / lam).sum() if combine == "max"
                     else np.sqrt(Vp / lam).sum())

    if combine not in ("max", "sum"):
        raise ValueError(f"combine must be 'max' or 'sum', got {combine!r}")
    lo = hi = 1.0
    while total(hi) > c:
        hi *= 2.0
    while total(lo) < c:
        lo *= 0.5
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if total(mid) > c:
            lo = mid
        else:
            hi = mid
        if hi / lo < 1.0 + 1e-14:
            break
    lam = math.sqrt(lo * hi)
    cb = Vp / lam if combine == "max" else np.sqrt(Vp / lam)
    return cb * (c / cb.sum())


# ---------------------------------------------------------------------------
# CompositePlan: the plan protocol over stitched block plans
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class CompositePlan(BasePlan):
    """Block plans behind the unified plan protocol (docs/DESIGN.md §12).

    ``table`` is None — there is no monolithic closure; ``sigma`` is the
    global σ² vector over the composite closure ``[∅] + Σ_b closure_b∖∅``
    (the shared ∅ first, then each block's non-empty cliques in block
    order), and every protocol query delegates to the block plans.
    """

    block_plans: Tuple[BasePlan, ...] = ()
    decomposition: Optional[Decomposition] = None
    _cliques: Optional[List[Clique]] = field(default=None, repr=False)
    _sigma_index: Optional[Dict[Clique, float]] = field(default=None,
                                                        repr=False)

    # ----------------------------------------------------------- identity
    @property
    def partition(self) -> Partition:
        return self.decomposition.partition

    @property
    def n_blocks(self) -> int:
        return len(self.block_plans)

    @property
    def domain(self) -> Domain:
        return self.decomposition.workload.domain

    @property
    def workload(self) -> MarginalWorkload:
        return self.decomposition.workload

    @property
    def cliques(self) -> List[Clique]:
        """Composite closure: shared ∅ first, then per-block non-∅ cliques."""
        if self._cliques is None:
            cl: List[Clique] = [()]
            for bp in self.block_plans:
                cl.extend(bp.table.cliques[1:])
            self._cliques = cl
        return self._cliques

    @property
    def sigmas(self) -> Dict[Clique, float]:
        if self._sigma_index is None:
            self._sigma_index = dict(zip(self.cliques,
                                         map(float, self.sigma)))
        return self._sigma_index

    def sigma2(self, clique: Clique) -> float:
        return self.sigmas[clique]

    # ---------------------------------------------------------- variances
    def variances_array(self) -> np.ndarray:
        """Per-workload-marginal variance: block delegation + straddler proxy.

        In-block rows are the block plan's exact Thm-4 variances; ∅ rows are
        σ²_∅; straddling rows report the product-of-blocks proxy
        ``Σ_p Var_p · Π_{p'≠p} n_cells(p')⁻²`` (module docstring).
        """
        d = self.decomposition
        m = len(d.workload.cliques)
        out = np.zeros(m)
        block_vars = [bp.variances_array() for bp in self.block_plans]
        for b, bv in enumerate(block_vars):
            sel = d.row_block == b
            if sel.any():
                out[sel] = bv[d.row_pos[sel]]
        out[d.row_block == ROW_EMPTY] = float(self.sigma[0])
        if d.part_row.size:
            pv = np.zeros(len(d.part_row))
            for b, bv in enumerate(block_vars):
                sel = d.part_block == b
                if sel.any():
                    pv[sel] = bv[d.part_pos[sel]]
            logc = np.log(d.part_cells)
            S = np.bincount(d.part_row, weights=logc, minlength=m)
            contrib = pv * np.exp(-2.0 * (S[d.part_row] - logc))
            out += np.bincount(d.part_row, weights=contrib, minlength=m)
        return out

    def marginal_variance(self, clique: Clique) -> float:
        """Variance of one workload marginal (straddlers: the product proxy)."""
        try:
            row = self.workload.cliques.index(clique)
        except ValueError:
            raise KeyError(clique) from None
        return float(self.variances_array()[row])

    def total_variance(self) -> float:
        cells = np.array([self.domain.n_cells(c)
                          for c in self.workload.cliques])
        return float(np.dot(cells, self.variances_array()))

    def rmse(self) -> float:
        return math.sqrt(self.total_variance() / self.workload.total_cells())

    def max_variance(self, weights: Optional[Mapping[Clique, float]] = None
                     ) -> float:
        wv = self.variances_array()
        if weights is None:
            return float(wv.max())
        w = np.array([float(weights.get(c, self.workload.weight(c)))
                      for c in self.workload.cliques])
        return float((wv / w).max())

    # --------------------------------------------------------- covariances
    def _block_of_clique(self, clique: Clique) -> int:
        """Owning block of a clique, or raise for cut-straddling cliques."""
        if not clique:
            return -1
        block_of = self.partition.block_of_array()
        bids = {int(block_of[a]) for a in clique}
        if len(bids) > 1 or -1 in bids:
            raise ValueError(f"clique {clique} straddles the partition; "
                             "covariance of product-corrected marginals is "
                             "not defined on the composite plan")
        return bids.pop()

    def marginal_covariance(self, a: Clique, b: Clique) -> float:
        """Aligned-cell covariance of reconstructed marginals A and B.

        Same block: the block plan's exact Thm-4 value.  Different blocks:
        only the shared ∅ measurement correlates them, so the covariance is
        exactly ``σ²_∅ · Π_{i∈A∪B} 1/n_i`` — identical to the monolithic
        planner's value for disjoint cliques.
        """
        ba, bb = self._block_of_clique(a), self._block_of_clique(b)
        if ba == bb and ba >= 0:
            return self.block_plans[ba].marginal_covariance(a, b)
        if ba < 0 or bb < 0 or not (set(a) & set(b)):
            table = self.block_plans[0].table
            cross = table.axis_cross
            outer = float(np.prod(cross[sorted(set(a) ^ set(b))])) \
                if (set(a) ^ set(b)) else 1.0
            return float(self.sigma[0]) * outer
        raise ValueError(f"cliques {a} and {b} overlap across blocks")

    def workload_covariances(self, pairs: Sequence[Tuple[Clique, Clique]]
                             ) -> np.ndarray:
        return np.array([self.marginal_covariance(a, b) for a, b in pairs])

    # -------------------------------------------------------------- engine
    def engine(self, use_kernel=None, precompile: bool = True, dtype=None,
               secure: bool = False, digits: int = 4, device=None):
        if secure:
            raise ValueError(
                "secure discrete release is not supported for CompositePlan: "
                "the integer-query rotation is defined per monolithic "
                "closure; plan the blocks separately or use the continuous "
                "engine")
        from repro_torch.engine.composite import CompositeEngine
        return CompositeEngine(self, use_kernel=use_kernel,
                               precompile=precompile, dtype=dtype,
                               device=device)


# ---------------------------------------------------------------------------
# The D&C selector
# ---------------------------------------------------------------------------

def _split_sigma(sig_all: np.ndarray, tables: Sequence[PlanTable]
                 ) -> Tuple[float, List[np.ndarray]]:
    """Unified σ² vector → (shared σ²_∅, per-block σ² vectors)."""
    s0 = float(sig_all[0])
    out, at = [], 1
    for t in tables:
        k = t.n - 1
        out.append(np.concatenate([[s0], sig_all[at:at + k]]))
        at += k
    return s0, out


def _composite_pcost(tables: Sequence[PlanTable],
                     sigmas: Sequence[np.ndarray]) -> float:
    """Total pcost counting the shared ∅ mechanism exactly once."""
    p0 = float(tables[0].p[0])
    s0 = float(sigmas[0][0])
    return float(sum(t.pcost(s) for t, s in zip(tables, sigmas))
                 - (len(tables) - 1) * p0 / s0)


def select_dnc(workload: MarginalWorkload, pcost_budget: float = 1.0,
               objective: str = "sum_of_variances",
               weights: Optional[Mapping[Clique, float]] = None,
               blocks=None, max_block: Optional[int] = None,
               partition: Optional[Partition] = None,
               **kw) -> CompositePlan:
    """Partition → per-block select → cross-block allocation → CompositePlan.

    ``blocks=`` / ``max_block=`` forward to
    :func:`repro_torch.core.partition.partition_attributes`; when neither is given,
    connected components are used with oversized components split at
    :data:`~repro_torch.core.partition.DEFAULT_MAX_BLOCK` attributes.  ``kw`` is
    forwarded to the per-block selector (``iters``/``tol``/``backend``/
    ``chunk``/``device`` for maxvar, ``loss``/``steps``/``lr``/``seed``/
    ``device`` for convex).

    SoV runs ONE closed form over the concatenated per-block coefficient
    arrays (sharing ∅), so a workload whose interaction graph is
    disconnected gets the *exact* monolithic optimum.  Maxvar/convex solve
    each block at unit budget (warm-starting the dual ascent from the
    previous same-shaped block), split the budget by
    :func:`allocate_budget`, and repair the shared σ²_∅ (module docstring).
    """
    if partition is None:
        mb = DEFAULT_MAX_BLOCK if (blocks is None and max_block is None) \
            else max_block
        partition = partition_attributes(workload, blocks=blocks,
                                         max_block=mb)
    if partition.n_blocks == 0:
        # degenerate: only ∅ cliques — nothing to decompose
        from .select import select
        return select(workload, pcost_budget, objective=objective,
                      weights=weights, strategy="monolithic", **kw)
    d = decompose(workload, partition, weights)
    tables = [plan_table(bw) for bw in d.block_workloads]
    c = float(pcost_budget)

    if objective in ("sum_of_variances", "sov", "rmse"):
        return _dnc_sov(d, tables, c)
    if objective in ("max_variance", "maxvar"):
        return _dnc_iterative(d, tables, c, "max_variance", kw)
    if objective == "convex":
        return _dnc_iterative(d, tables, c, "convex", kw)
    raise ValueError(objective)


def _dnc_sov(d: Decomposition, tables: List[PlanTable], c: float
             ) -> CompositePlan:
    """One unified Lemma-2 closed form over all blocks (shared ∅)."""
    from .select import Plan
    p0 = float(tables[0].p[0])
    p_all = np.concatenate([[p0]] + [t.p[1:] for t in tables])
    v_all = np.concatenate(
        [[sum(float(t.v[0]) for t in tables) + d.empty_weight]]
        + [t.v[1:] for t in tables])
    sig_all = sov_closed_form(p_all, v_all, c)
    s0, sigmas = _split_sigma(sig_all, tables)
    block_plans = tuple(
        Plan(t, s, "sum_of_variances", pcost=t.pcost(s),
             loss_value=float(np.dot(t.v, s)))
        for t, s in zip(tables, sigmas))
    return CompositePlan(
        None, sig_all, "sum_of_variances",
        pcost=_composite_pcost(tables, sigmas),
        loss_value=float(np.dot(v_all, sig_all)),
        block_plans=block_plans, decomposition=d)


def _dnc_iterative(d: Decomposition, tables: List[PlanTable], c: float,
                   objective: str, kw: dict) -> CompositePlan:
    """Unit-budget block solves (warm-started) + bisection allocation."""
    from .select import select_convex, select_max_variance
    unit: List[BasePlan] = []
    warm_mu: Dict[int, np.ndarray] = {}
    for t, bw in zip(tables, d.block_workloads):
        if objective == "max_variance":
            bp = select_max_variance(bw, 1.0, table=t,
                                     mu0=warm_mu.get(t.m), **kw)
            if getattr(bp, "mu", None) is not None:
                warm_mu[t.m] = bp.mu
        else:
            bp = select_convex(bw, 1.0, table=t, **kw)
        unit.append(bp)

    loss = kw.get("loss", "max_variance")
    combine = "sum" if (objective == "convex"
                        and loss == "sum_of_variances") else "max"
    V = np.array([bp.loss_value for bp in unit])
    cb = allocate_budget(V, c, combine)

    # 1-homogeneity: block b at budget c_b is the unit plan scaled by 1/c_b.
    sigmas = [bp.sigma / cb[b] for b, bp in enumerate(unit)]
    # ∅-repair: pin the shared σ²_∅ to the tightest block's choice (variances
    # only drop), then rescale so the once-counted pcost is tight again.
    s0 = min(float(s[0]) for s in sigmas)
    for s in sigmas:
        s[0] = s0
    total = _composite_pcost(tables, sigmas)
    scale = total / c                     # ≤ 1: shrinking σ² tightens pcost
    sigmas = [s * scale for s in sigmas]

    from .select import Plan
    block_plans = tuple(
        Plan(t, s, objective, pcost=t.pcost(s),
             loss_value=float((t.variances(s)
                               / t.weight_vector(None)).max()),
             mu=getattr(bp, "mu", None))
        for t, s, bp in zip(tables, sigmas, unit))
    sig_all = np.concatenate([[sigmas[0][0]]] + [s[1:] for s in sigmas])
    plan = CompositePlan(
        None, sig_all, objective, pcost=_composite_pcost(tables, sigmas),
        loss_value=0.0, block_plans=block_plans, decomposition=d)
    # same convention as the monolithic maxvar loss: max_r Var_r / Imp_r
    plan.loss_value = float((plan.variances_array() / d.row_weight).max())
    return plan


# ---------------------------------------------------------------------------
# Accuracy harness: D&C vs monolithic where both are feasible
# ---------------------------------------------------------------------------

def compare_with_monolithic(workload: MarginalWorkload,
                            pcost_budget: float = 1.0,
                            objective: str = "sum_of_variances",
                            weights: Optional[Mapping[Clique, float]] = None,
                            blocks=None, max_block: Optional[int] = None,
                            **kw) -> Dict[str, float]:
    """Plan both routes and report total-variance parity (CI gates on this).

    Returns total variances, their ratio (D&C / monolithic), the worst
    per-marginal relative deviation, and whether the partition was exact
    (no straddling cliques — where SoV parity must be 1.0 to fp accuracy).
    """
    from .select import select
    mono = select(workload, pcost_budget, objective=objective,
                  weights=weights, strategy="monolithic", **kw)
    dnc = select_dnc(workload, pcost_budget, objective=objective,
                     weights=weights, blocks=blocks, max_block=max_block,
                     **kw)
    tv_m, tv_d = mono.total_variance(), dnc.total_variance()
    vm, vd = mono.variances_array(), dnc.variances_array()
    rel = float(np.max(np.abs(vd - vm) / np.maximum(vm, 1e-300)))
    return dict(total_monolithic=tv_m, total_dnc=tv_d,
                ratio=tv_d / tv_m, max_rel_marginal_diff=rel,
                n_blocks=float(dnc.n_blocks),
                exact_partition=float(dnc.decomposition.n_straddlers == 0),
                pcost_monolithic=mono.pcost, pcost_dnc=dnc.pcost)
