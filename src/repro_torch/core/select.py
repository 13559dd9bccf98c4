"""The selection phase: choose noise scales σ²_A for every A in closure(Wkload).

The optimizers run against the arrayized PlanTable IR
(:mod:`repro_torch.core.plantable`): the closure, the Thm-3/4 coefficient
vectors and the workload↔closure incidence are flat arrays built once per
workload, and every objective is segment-sums over them.

* ``select_sum_of_variances`` — the closed form of Lemma 2 (no iterations);
* ``select_max_variance``    — exact max-variance via the concave dual: the
  exponentiated-gradient ascent runs as ``np.bincount`` segment-sums on the
  host (``backend="numpy"``) or as a torch loop of two segment-sum
  contractions per step on the device (``backend="device"``, chunked, with
  float64 host checkpoints certifying the primal–dual gap);
* ``select_convex``          — any *regular*, positively 1-homogeneous loss of
  the per-marginal variances, user callables included: Adam on the
  scale-invariant product ``pcost(σ²)·L(Var(σ²))`` in log-space with torch
  autograd, then a rescale so the privacy constraint is tight;
* ``select_utility_constrained`` — the paper's Eq. 2, by rescaling Eq. 1.

The legacy dict/itertools coefficient path survives as ``_coefficients`` /
``legacy_*_sigmas``: the float64 oracles the tests compare the IR against.

Every entry point that takes ``strategy`` routes through
:func:`_route_strategy`: ``"dnc"`` (or ``"auto"`` past :data:`AUTO_DNC_NNZ`
incidence entries, or ``blocks=``/``max_block=``) plans by divide and
conquer (:func:`repro_torch.core.composite.select_dnc`) and returns a
:class:`~repro_torch.core.composite.CompositePlan`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.kron_matvec._layout import resolve_device

from .domain import Clique, MarginalWorkload, closure, subsets
from .plantable import BasePlan, PlanTable, plan_table, sov_closed_form
from .residual import p_coeff, variance_coeff

LossSpec = Union[str, Callable]


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
               secure: bool = False, digits: int = 4, device=None):
        if secure:
            from repro_torch.engine.discrete_engine import DiscreteEngine
            return DiscreteEngine(self, use_kernel=use_kernel,
                                  precompile=precompile, dtype=dtype,
                                  digits=digits, device=device)
        from repro_torch.engine.engine import MarginalEngine
        return MarginalEngine(self, use_kernel=use_kernel,
                              precompile=precompile, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Legacy dict/itertools coefficient path (float64 oracles the tests compare
# the IR against)
# ---------------------------------------------------------------------------

def _coefficients(workload: MarginalWorkload,
                  weights: Optional[Mapping[Clique, float]] = None
                  ) -> Tuple[List[Clique], np.ndarray, np.ndarray]:
    """Closure cliques, pcost coefficients p_A, and SoV coefficients v_A (§6.1)."""
    dom = workload.domain
    cl = closure(workload.cliques)
    index = {c: i for i, c in enumerate(cl)}
    p = np.array([p_coeff(dom, c) for c in cl])
    v = np.zeros(len(cl))
    for wc in workload.cliques:
        imp = float(weights.get(wc, 1.0)) if weights is not None else workload.weight(wc)
        for sub in subsets(wc):
            v[index[sub]] += imp * variance_coeff(dom, sub, wc)
    return cl, p, v


def _variance_matrix(workload: MarginalWorkload, cl: List[Clique]
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO (rows → workload idx, cols → closure idx, coef) for Var_A(σ²) (Thm 4)."""
    dom = workload.domain
    index = {c: i for i, c in enumerate(cl)}
    rows, cols, vals = [], [], []
    for wi, wc in enumerate(workload.cliques):
        for sub in subsets(wc):
            rows.append(wi)
            cols.append(index[sub])
            vals.append(variance_coeff(dom, sub, wc))
    return np.array(rows, np.int32), np.array(cols, np.int32), np.array(vals)


def legacy_sov_sigmas(workload: MarginalWorkload, pcost_budget: float = 1.0,
                      weights: Optional[Mapping[Clique, float]] = None
                      ) -> Dict[Clique, float]:
    """Lemma-2 closed form over the dict/itertools coefficients (oracle)."""
    cl, p, v = _coefficients(workload, weights)
    sig = sov_closed_form(p, v, pcost_budget)
    return dict(zip(cl, map(float, sig)))


def legacy_maxvar_sigmas(workload: MarginalWorkload, pcost_budget: float = 1.0,
                         weights: Optional[Mapping[Clique, float]] = None,
                         iters: int = 4000, tol: float = 1e-9
                         ) -> Tuple[Dict[Clique, float], float]:
    """Historical host-loop dual ascent (``np.add.at`` per iteration)."""
    dom = workload.domain
    cl = closure(workload.cliques)
    p = np.array([p_coeff(dom, c) for c in cl])
    m = len(workload.cliques)
    cw = np.array([float((weights or {}).get(c, workload.weight(c)))
                   for c in workload.cliques])
    rows, cols, vals = _variance_matrix(workload, cl)
    c = float(pcost_budget)
    mu = np.full(m, 1.0 / m)
    best = None
    for t in range(iters):
        v = np.zeros(len(cl))
        np.add.at(v, cols, vals * (mu / cw)[rows])
        sq = np.sqrt(np.maximum(v, 0.0) * p)
        T = sq.sum() ** 2 / c
        with np.errstate(divide="ignore"):
            u = np.sqrt(T * p / (c * np.maximum(v, 1e-300)))
        var = np.zeros(m)
        np.add.at(var, rows, vals * u[cols])
        var = var / cw
        primal = float(var.max())
        gap = primal - T
        if best is None or primal < best[0]:
            best = (primal, u.copy())
        if gap <= tol * max(primal, 1e-300):
            break
        eta = 2.0 * math.log(max(m, 2)) / (primal * math.sqrt(t + 1.0))
        mu = mu * np.exp(eta * (var - primal))
        mu = np.maximum(mu, 1e-300)
        mu /= mu.sum()
    primal, u = best
    return dict(zip(cl, map(float, u))), primal


def _route_strategy(strategy: str, workload: MarginalWorkload, objective: str,
                    pcost_budget, weights, blocks, max_block, kw):
    """Resolve the ``strategy`` switch shared by all select entry points.

    Returns a :class:`~repro_torch.core.composite.CompositePlan` when the
    divide-and-conquer route is taken, ``None`` when the caller should run
    the monolithic path.  ``"auto"`` stays monolithic whenever the closure
    is comfortably in memory and switches to D&C only past
    :data:`AUTO_DNC_NNZ` estimated incidence entries (or when ``blocks=`` /
    ``max_block=`` ask for a split).
    """
    if strategy == "monolithic":
        if blocks is not None or max_block is not None:
            raise ValueError("blocks=/max_block= require strategy='dnc' "
                             "(or 'auto')")
        return None
    if strategy == "auto":
        est_nnz = sum(1 << len(c) for c in workload.cliques)
        if est_nnz <= AUTO_DNC_NNZ and blocks is None and max_block is None:
            return None
    elif strategy != "dnc":
        raise ValueError(f"unknown strategy {strategy!r}")
    from .composite import select_dnc
    return select_dnc(workload, pcost_budget, objective=objective,
                      weights=weights, blocks=blocks, max_block=max_block,
                      **kw)


#: strategy="auto" switches to divide-and-conquer past this estimated
#: closure-incidence size (the d=100 all-<=3-way headline is ~1.3M).
AUTO_DNC_NNZ = 4_000_000


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
    routed = _route_strategy(strategy, workload, "sum_of_variances",
                             pcost_budget, weights, blocks, max_block, {})
    if routed is not None:
        return routed
    table = plan_table(workload) if table is None else table
    v = table.sov_coeffs(weights)
    sig = sov_closed_form(table.p, v, pcost_budget)
    return Plan(table, sig, "sum_of_variances",
                pcost=table.pcost(sig), loss_value=float(np.dot(v, sig)))


def _maxvar_eval_fp64(mu, p, rows, cols, vals, cw, c, n, m):
    """Closed-form (primal value, primal σ², dual value) at dual point μ."""
    mu = mu / mu.sum()
    v = np.bincount(cols, weights=vals * (mu / cw)[rows], minlength=n)
    sq = np.sqrt(np.maximum(v, 0.0) * p)
    T = sq.sum() ** 2 / c
    with np.errstate(divide="ignore"):
        u = np.sqrt(T * p / (c * np.maximum(v, 1e-300)))
    var = np.bincount(rows, weights=vals * u[cols], minlength=m) / cw
    return float(var.max()), u, float(T)


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


def _maxvar_run_chunk(mu, bp, bmu, t0: int, p, rows, cols, vals, icw,
                      cc: float, tiny: float, logm: float, chunk: int):
    """``chunk`` exp-gradient iterations on the device: each one two
    contractions over the incidence (the JAX package's ``lax.scan`` over
    ``segment_sum``), as sums over the :class:`~repro_torch.core.segment.
    Segments` ``rows`` and ``cols``, whose order of addition is fixed by
    the data: the same inputs give the same bits on every call.  Nothing
    here reads a value back to the host, so the iterations queue on the
    device without a sync."""
    for t in range(t0, t0 + chunk):
        v = cols.sum(vals * rows.gather(mu * icw))
        sq = torch.sqrt(torch.clamp_min(v, 0.0) * p)
        T = sq.sum() ** 2 / cc
        u = torch.sqrt(T * p / (cc * torch.clamp_min(v, tiny)))
        var = rows.sum(vals * cols.gather(u)) * icw
        primal = var.max()
        better = primal < bp
        bp = torch.where(better, primal, bp)
        bmu = torch.where(better, mu, bmu)
        eta = logm / (primal * math.sqrt(t + 1.0))
        mu = torch.clamp_min(mu * torch.exp(eta * (var - primal)), tiny)
        mu = mu / mu.sum()
    return mu, bp, bmu


def _maxvar_device(table, cw, c, iters, tol, chunk, mu0=None, device=None):
    """Chunked device dual ascent (:func:`_maxvar_run_chunk`) with float64
    host checkpoints at chunk boundaries: they track the best primal and
    certify the primal–dual gap.

    ``mu0`` warm-starts the dual point; a warm start also shrinks the first
    chunk so the gap certificate is consulted early.  The contractions add
    in an order fixed by the data, so two calls on one device return the
    same plan bit for bit; the CPU and the card differ by their arithmetic
    only, and a device plan is certified by its float64 gap."""
    n, m = table.n, table.m
    p, rows, cols, vals = table.p, table.inc_rows, table.inc_cols, table.inc_vals
    p_d, _rows, _cols, vals_d = table.device_arrays(device)
    rows_d, cols_d = table.device_segments(device)
    dev, dt = p_d.device, p_d.dtype
    icw = torch.as_tensor(1.0 / cw, dtype=dt, device=dev)
    tiny = float(torch.finfo(dt).tiny)
    logm = 2.0 * math.log(max(m, 2))
    cc = float(c)

    mu_h = np.full(m, 1.0 / m) if mu0 is None else _normalize_mu0(mu0, m)
    mu_d = torch.as_tensor(mu_h, dtype=dt, device=dev)
    bp_d = torch.tensor(math.inf, dtype=dt, device=dev)
    bmu_d = mu_d
    best_primal, best_u, best_mu, dual_best = math.inf, None, mu_h, -math.inf
    t0 = 0
    first_chunk = min(chunk, 25) if mu0 is not None else chunk
    while t0 < iters:
        # Exact iteration count: the tail chunk shrinks instead of overrunning.
        k = min(first_chunk if t0 == 0 else chunk, iters - t0)
        mu_d, bp_d, bmu_d = _maxvar_run_chunk(
            mu_d, bp_d, bmu_d, t0, p_d, rows_d, cols_d, vals_d, icw, cc, tiny,
            logm, k)
        t0 += k
        for cand in (mu_d.cpu().numpy(), bmu_d.cpu().numpy()):
            primal, u, T = _maxvar_eval_fp64(cand, p, rows, cols, vals,
                                             cw, cc, n, m)
            dual_best = max(dual_best, T)
            if primal < best_primal:
                best_primal, best_u, best_mu = primal, u, cand
        if best_primal - dual_best <= tol * max(best_primal, 1e-300):
            break
    return best_u, best_primal, best_mu


#: backend="auto" runs the device loop from this many incidence entries up.
AUTO_DEVICE_NNZ = 20_000


def select_max_variance(workload: MarginalWorkload, pcost_budget: float = 1.0,
                        weights: Optional[Mapping[Clique, float]] = None,
                        iters: int = 4000, tol: float = 1e-9,
                        table: Optional[PlanTable] = None,
                        backend: str = "auto", chunk: int = 250,
                        mu0: Optional[np.ndarray] = None,
                        strategy: str = "monolithic",
                        blocks=None, max_block=None, device=None) -> BasePlan:
    """Exact max-variance selection via the concave dual.

    min_σ max_A Var_A/c_A  s.t. pcost ≤ c  has Lagrangian dual
        max_{μ ∈ Δ} g(μ),   g(μ) = (Σ_{A'} sqrt(p_{A'} v_{A'}(μ)))² / c
    where v(μ) are the Lemma-2 SoV coefficients under workload weights μ/c_A.
    Exponentiated-gradient ascent on μ runs as segment-sums over the IR
    incidence, and optimality is certified by the float64 primal–dual gap.

    ``backend="numpy"`` is the ``np.bincount`` host loop; ``"device"`` the
    chunked torch loop on ``device`` (CUDA unless ``device="cpu"``; it
    raises without CUDA otherwise); ``"auto"`` takes the device loop from
    :data:`AUTO_DEVICE_NNZ` incidence entries up and the host loop below.
    ``mu0`` warm-starts the dual ascent from ``plan.mu`` of an earlier plan.
    """
    routed = _route_strategy(strategy, workload, "max_variance", pcost_budget,
                             weights, blocks, max_block,
                             dict(iters=iters, tol=tol, backend=backend,
                                  chunk=chunk, device=device))
    if routed is not None:
        return routed
    table = plan_table(workload) if table is None else table
    cw = table.weight_vector(weights, default_to_workload=True)
    c = float(pcost_budget)
    if backend == "auto":
        backend = ("device" if table.inc_vals.size >= AUTO_DEVICE_NNZ
                   else "numpy")
    if backend == "device":
        u, primal, mu = _maxvar_device(table, cw, c, iters, tol, chunk, mu0,
                                       resolve_device(device))
    elif backend == "numpy":
        u, primal, mu = _maxvar_numpy(table.p, table.inc_rows, table.inc_cols,
                                      table.inc_vals, cw, c, iters, tol,
                                      table.n, table.m, mu0)
    else:
        raise ValueError(backend)
    return Plan(table, u, "max_variance",
                pcost=table.pcost(u), loss_value=primal, mu=mu)


# ---------------------------------------------------------------------------
# Generic 1-homogeneous convex losses (built-in or user-supplied callables)
# ---------------------------------------------------------------------------

def select_convex(workload: MarginalWorkload, pcost_budget: float = 1.0,
                  loss: LossSpec = "max_variance",
                  weights: Optional[Mapping[Clique, float]] = None,
                  steps: int = 3000, lr: float = 0.05, seed: int = 0,
                  table: Optional[PlanTable] = None,
                  strategy: str = "monolithic",
                  blocks=None, max_block=None, device=None) -> BasePlan:
    """Solve privacy-constrained selection for a regular 1-homogeneous loss.

    ``loss`` is ``'max_variance'`` (max_A Var_A / c_A, smoothed by an
    annealed logsumexp during the solve), ``'sum_of_variances'`` (sanity
    path), or any positively 1-homogeneous, torch-differentiable callable
    ``L(var)`` of the weight-normalized per-marginal variance vector
    ``var = Var(σ²)/c`` (a float64 tensor of shape (m,), strictly positive)
    returning a scalar tensor.  Adam runs on ``device`` (CUDA unless
    ``device="cpu"``) with torch autograd.  The final ``loss_value`` is
    computed before the plan is constructed, in float64: for a callable, by
    calling it on a float64 CPU tensor and taking ``float()`` (the JAX
    package calls it on a numpy array).  ``seed`` is accepted for signature
    parity; the solve draws no randomness.  The variance contraction and its
    gradient are segment sums whose order of addition is fixed by the data
    (:class:`~repro_torch.core.segment.Segments`), so two calls on one
    device return the same plan bit for bit.
    """
    routed = _route_strategy(strategy, workload, "convex", pcost_budget,
                             weights, blocks, max_block,
                             dict(loss=loss, steps=steps, lr=lr, seed=seed,
                                  device=device))
    if routed is not None:
        return routed
    table = plan_table(workload) if table is None else table
    v_lin = table.sov_coeffs(weights)       # historical default-1.0 weighting
    w = table.weight_vector(weights, default_to_workload=True)
    if not callable(loss) and loss not in ("max_variance", "sum_of_variances"):
        raise ValueError(loss)

    dev = resolve_device(device)
    p_d, _rows, _cols, vals_d = table.device_arrays(dev)
    rows_d, cols_d = table.device_segments(dev)
    dt = p_d.dtype
    w_d = torch.as_tensor(w, dtype=dt, device=dev)
    v_lin_d = torch.as_tensor(v_lin, dtype=dt, device=dev)

    def loss_fn(theta, tau):
        u = torch.exp(theta)
        var = rows_d.sum(vals_d * cols_d.gather(u)) / w_d
        if callable(loss):
            L = loss(var)
        elif loss == "max_variance":
            L = tau * torch.logsumexp(var / tau, dim=0)
        else:
            L = torch.dot(v_lin_d, u)
        P = torch.sum(p_d / u)
        return torch.log(P) + torch.log(L)  # scale-invariant product objective

    # Init from the SoV closed form (good warm start).
    warm = select_sum_of_variances(workload, pcost_budget, weights, table=table)
    theta = torch.log(torch.as_tensor(np.maximum(warm.sigma, 1e-12), dtype=dt,
                                      device=dev))
    tau_scale = float(np.mean(table.variances(warm.sigma) / w))
    mom = torch.zeros_like(theta)
    vel = torch.zeros_like(theta)
    for i in range(steps):
        tau = 10.0 ** (-3.0 * i / steps) * tau_scale
        th = theta.detach().requires_grad_(True)
        g, = torch.autograd.grad(loss_fn(th, tau), th)
        mom = 0.9 * mom + 0.1 * g
        vel = 0.999 * vel + 0.001 * g * g
        mh = mom / (1 - 0.9 ** (i + 1.0))
        vh = vel / (1 - 0.999 ** (i + 1.0))
        theta = theta.detach() - lr * mh / (torch.sqrt(vh) + 1e-9)

    u = np.exp(theta.cpu().numpy().astype(np.float64))
    # Rescale so pcost is exactly the budget (tight at the optimum).
    u = u * (table.pcost(u) / float(pcost_budget))
    # float64 loss at the solution — set at construction, never patched after.
    var64 = table.variances(u) / w
    if callable(loss):
        loss_value = float(loss(torch.as_tensor(var64, dtype=torch.float64)))
        objective = getattr(loss, "__name__", "convex")
    elif loss == "max_variance":
        loss_value = float(var64.max())
        objective = loss
    else:
        loss_value = float(np.dot(v_lin, u))
        objective = loss
    return Plan(table, u, objective, pcost=table.pcost(u),
                loss_value=loss_value)


def select(workload: MarginalWorkload, pcost_budget: float = 1.0,
           objective: Union[str, Callable] = "sum_of_variances",
           weights: Optional[Mapping[Clique, float]] = None,
           loss: Optional[LossSpec] = None, strategy: str = "auto",
           **kw) -> BasePlan:
    """Dispatch on objective: sov | maxvar | convex (user losses welcome).

    ``objective='convex'`` routes to :func:`select_convex`; pass the loss via
    ``loss=`` (a name or a positively 1-homogeneous torch-differentiable
    callable).  A callable ``objective`` is shorthand for the same thing.

    ``strategy`` picks the planning route: ``"monolithic"`` builds one
    PlanTable over the whole closure, ``"dnc"`` partitions the attributes
    and plans each block independently
    (:func:`repro_torch.core.composite.select_dnc`, returning a
    :class:`~repro_torch.core.composite.CompositePlan`), and the default
    ``"auto"`` stays monolithic until the closure would outgrow memory
    (:data:`AUTO_DNC_NNZ` incidence entries).  ``blocks=`` / ``max_block=``
    (forwarded to the partitioner) force the D&C route when given.
    """
    if callable(objective):
        return select_convex(workload, pcost_budget, loss=objective,
                             weights=weights, strategy=strategy, **kw)
    if objective in ("sum_of_variances", "sov", "rmse"):
        return select_sum_of_variances(workload, pcost_budget, weights,
                                       strategy=strategy, **kw)
    if objective in ("max_variance", "maxvar"):
        return select_max_variance(workload, pcost_budget, weights,
                                   strategy=strategy, **kw)
    if objective == "convex":
        return select_convex(workload, pcost_budget,
                             loss="max_variance" if loss is None else loss,
                             weights=weights, strategy=strategy, **kw)
    raise ValueError(objective)


def select_utility_constrained(workload: MarginalWorkload, loss_budget: float,
                               objective: str = "sum_of_variances",
                               weights: Optional[Mapping[Clique, float]] = None,
                               **kw) -> Plan:
    """Equation 2 of the paper: minimize pcost subject to loss ≤ γ.

    Both paper objectives are positively 1-homogeneous in the σ², and pcost is
    (−1)-homogeneous, so the Eq.-1 solution at any budget rescales exactly onto
    the Eq.-2 constraint:  if Plan(c=1) attains loss L₁, then scaling every
    σ²_A by L₁/γ attains loss γ at pcost L₁/γ — and this is optimal, since a
    cheaper mechanism meeting the loss bound would rescale back to beat the
    Eq.-1 optimum.
    """
    base = select(workload, pcost_budget=1.0, objective=objective,
                  weights=weights, **kw)
    if objective in ("sum_of_variances", "sov", "rmse"):
        w = base.table.weight_vector(weights, default_to_workload=True)
        l1 = float(np.dot(w, base.variances_array()))
    else:
        l1 = base.max_variance(weights)
    scale = float(loss_budget) / l1          # loss is 1-homogeneous in σ²
    return Plan(base.table, base.sigma * scale,
                base.objective + "_utility_constrained",
                pcost=base.pcost / scale, loss_value=float(loss_budget))
