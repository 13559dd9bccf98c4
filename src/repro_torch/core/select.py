"""The selection phase: choose noise scales σ²_A for every A in closure(Wkload).

The optimizers run against the arrayized PlanTable IR
(:mod:`repro_torch.core.plantable`): the closure, the Thm-3/4 coefficient
vectors and the workload↔closure incidence are flat arrays built once per
workload, and every objective is segment-sums over them.

* ``select_sum_of_variances`` — the closed form of Lemma 2 (no iterations);
* ``select_max_variance``    — exact max-variance via the concave dual, the
  exponentiated-gradient host loop (``backend="numpy"``), certified by the
  fp64 primal–dual gap.

Not ported yet, and raising ``NotImplementedError`` with the ROADMAP item
that ports them: the device max-variance loop (``backend="device"``),
``select_convex``, and divide-and-conquer planning (``strategy="dnc"``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from .domain import Clique, MarginalWorkload
from .plantable import BasePlan, PlanTable, plan_table, sov_closed_form


@dataclass(eq=False)
class Plan(BasePlan):
    """Output of the selection phase: which base mechanisms to run, at what scale.

    ``mu`` is the max-variance dual point that produced the plan (None for
    other objectives).
    """

    mu: Optional[np.ndarray] = None

    def marginal_variance(self, clique: Clique) -> float:
        """Per-cell variance of the reconstructed marginal on ``clique`` (Thm 4)."""
        return self.table.variance_of(self.sigma, clique)

    def total_variance(self) -> float:
        """Sum over workload marginals of (#cells × per-cell variance)."""
        cells = np.array([self.domain.n_cells(c) for c in self.workload.cliques])
        return float(np.dot(cells, self.variances_array()))

    def rmse(self) -> float:
        """Root mean squared error over all workload cells (paper's RMSE metric)."""
        return math.sqrt(self.total_variance() / self.workload.total_cells())

    def max_variance(self, weights: Optional[Mapping[Clique, float]] = None) -> float:
        wv = self.variances_array()
        if weights is None:
            return float(wv.max())
        w = self.table.weight_vector(weights, default_to_workload=False)
        return float((wv / w).max())

    def marginal_covariance(self, a: Clique, b: Clique) -> float:
        """Aligned-cell covariance between reconstructed marginals A and B."""
        return self.table.cross_covariance(self.sigma, a, b)

    def workload_covariances(self, pairs: Sequence[Tuple[Clique, Clique]]
                             ) -> np.ndarray:
        """Batched cross-marginal covariances: one segment-sum for all pairs."""
        return self.table.cross_covariances(self.sigma, pairs)

    def engine(self, use_kernel=None, precompile: bool = True, dtype=None,
               secure: bool = False, device=None):
        if secure:
            raise NotImplementedError("the secure discrete release is not "
                                      "ported yet (ROADMAP queue 1, item 8)")
        from repro_torch.engine.engine import MarginalEngine
        return MarginalEngine(self, use_kernel=use_kernel,
                              precompile=precompile, dtype=dtype, device=device)


#: strategy="auto" would switch to divide-and-conquer past this estimated
#: closure-incidence size (the d=100 all-<=3-way headline is ~1.3M).
AUTO_DNC_NNZ = 4_000_000


def _check_strategy(strategy: str, workload: MarginalWorkload,
                    blocks, max_block) -> None:
    """Only the monolithic route is ported; the D&C route raises."""
    if strategy == "monolithic" and blocks is None and max_block is None:
        return
    if strategy == "auto" and blocks is None and max_block is None:
        est_nnz = sum(1 << len(c) for c in workload.cliques)
        if est_nnz <= AUTO_DNC_NNZ:
            return
    elif strategy not in ("monolithic", "auto", "dnc"):
        raise ValueError(f"unknown strategy {strategy!r}")
    raise NotImplementedError("divide-and-conquer planning is not ported yet "
                              "(ROADMAP queue 1, item 9)")


def select_sum_of_variances(workload: MarginalWorkload, pcost_budget: float = 1.0,
                            weights: Optional[Mapping[Clique, float]] = None,
                            table: Optional[PlanTable] = None,
                            strategy: str = "monolithic",
                            blocks=None, max_block=None) -> BasePlan:
    """Closed-form optimum for weighted sum of per-cell variances (Lemma 2).

    Cliques with v_A == 0 (needed for reconstruction completeness but receiving
    zero objective weight) get a vanishing budget sliver, computed overflow-safe
    (see :func:`repro_torch.core.plantable.sov_closed_form`).
    """
    _check_strategy(strategy, workload, blocks, max_block)
    table = plan_table(workload) if table is None else table
    v = table.sov_coeffs(weights)
    sig = sov_closed_form(table.p, v, pcost_budget)
    return Plan(table, sig, "sum_of_variances",
                pcost=table.pcost(sig), loss_value=float(np.dot(v, sig)))


def _normalize_mu0(mu0, m) -> np.ndarray:
    """Validate/normalize a warm-start dual point onto the simplex."""
    mu = np.asarray(mu0, np.float64).reshape(-1)
    if mu.shape != (m,):
        raise ValueError(f"mu0 has shape {mu.shape}, workload has {m} "
                         "marginals")
    mu = np.maximum(mu, 1e-300)
    return mu / mu.sum()


def _maxvar_numpy(p, rows, cols, vals, cw, c, iters, tol, n, m, mu0=None):
    """Arrayized host loop: two bincount segment-sums per iteration.

    ``mu0`` warm-starts the dual ascent; the fp64 primal–dual gap certificate
    exits the loop the moment optimality is proven.
    """
    mu = np.full(m, 1.0 / m) if mu0 is None else _normalize_mu0(mu0, m)
    best_primal, best_u, best_mu, dual_best = math.inf, None, mu, -math.inf
    logm = 2.0 * math.log(max(m, 2))
    for t in range(iters):
        v = np.bincount(cols, weights=vals * (mu / cw)[rows], minlength=n)
        sq = np.sqrt(np.maximum(v, 0.0) * p)
        T = sq.sum() ** 2 / c
        with np.errstate(divide="ignore"):
            u = np.sqrt(T * p / (c * np.maximum(v, 1e-300)))
        var = np.bincount(rows, weights=vals * u[cols], minlength=m) / cw
        primal = float(var.max())
        dual_best = max(dual_best, float(T))
        if primal < best_primal:
            best_primal, best_u, best_mu = primal, u, mu
        if best_primal - dual_best <= tol * max(best_primal, 1e-300):
            break
        eta = logm / (primal * math.sqrt(t + 1.0))
        mu = mu * np.exp(eta * (var - primal))
        mu = np.maximum(mu, 1e-300)
        mu /= mu.sum()
    return best_u, best_primal, best_mu


def select_max_variance(workload: MarginalWorkload, pcost_budget: float = 1.0,
                        weights: Optional[Mapping[Clique, float]] = None,
                        iters: int = 4000, tol: float = 1e-9,
                        table: Optional[PlanTable] = None,
                        backend: str = "auto",
                        mu0: Optional[np.ndarray] = None,
                        strategy: str = "monolithic",
                        blocks=None, max_block=None) -> BasePlan:
    """Exact max-variance selection via the concave dual.

    min_σ max_A Var_A/c_A  s.t. pcost ≤ c  has Lagrangian dual
        max_{μ ∈ Δ} g(μ),   g(μ) = (Σ_{A'} sqrt(p_{A'} v_{A'}(μ)))² / c
    where v(μ) are the Lemma-2 SoV coefficients under workload weights μ/c_A.
    Exponentiated-gradient ascent on μ runs as ``np.bincount`` segment-sums
    over the IR incidence, and optimality is certified by the primal–dual gap.
    ``backend="auto"`` resolves to ``"numpy"``, the one backend ported.
    """
    _check_strategy(strategy, workload, blocks, max_block)
    if backend == "device":
        raise NotImplementedError("the device max-variance loop is not ported "
                                  "yet (ROADMAP queue 1, item 2)")
    if backend not in ("auto", "numpy"):
        raise ValueError(backend)
    table = plan_table(workload) if table is None else table
    cw = table.weight_vector(weights, default_to_workload=True)
    u, primal, mu = _maxvar_numpy(table.p, table.inc_rows, table.inc_cols,
                                  table.inc_vals, cw, float(pcost_budget),
                                  iters, tol, table.n, table.m, mu0)
    return Plan(table, u, "max_variance",
                pcost=table.pcost(u), loss_value=primal, mu=mu)


def select_convex(workload: MarginalWorkload, *args, **kw) -> BasePlan:
    """Generic 1-homogeneous convex losses: not ported yet."""
    raise NotImplementedError("select_convex is not ported yet "
                              "(ROADMAP queue 1, item 2)")


def select(workload: MarginalWorkload, pcost_budget: float = 1.0,
           objective: str = "sum_of_variances",
           weights: Optional[Mapping[Clique, float]] = None,
           strategy: str = "auto", **kw) -> BasePlan:
    """Dispatch on objective: ``sum_of_variances`` | ``max_variance``.

    ``objective="convex"`` or a callable objective raises until
    ``select_convex`` is ported.
    """
    if callable(objective) or objective == "convex":
        return select_convex(workload)
    if objective in ("sum_of_variances", "sov", "rmse"):
        return select_sum_of_variances(workload, pcost_budget, weights,
                                       strategy=strategy, **kw)
    if objective in ("max_variance", "maxvar"):
        return select_max_variance(workload, pcost_budget, weights,
                                   strategy=strategy, **kw)
    raise ValueError(objective)
