r"""PlanTable: the arrayized planner IR — the port's copy of
``repro.core.plantable`` (host numpy, unchanged but for ``device_arrays``
and ``device_segments``).

The whole workload closure is flattened into indexed arrays, built ONCE per
workload:

* ``cliques`` — the downward closure, sorted by (len, lex) exactly like
  :func:`repro_torch.core.domain.closure`;
* ``inc_rows/inc_cols/inc_vals`` — COO incidence between workload marginals
  (rows) and closure cliques (cols) with the Thm-4 variance coefficients as
  values, built by rank-indexed combinatorics (encoded integer keys located
  with ``np.unique``);
* ``p`` — the Thm-3 pcost coefficients;
* ``axis_*`` — per-attribute factor vectors (plain marginals: ``(n−1)/n``,
  ``1/n²`` and ``1/n``).

Every selection objective and every variance/covariance query is then a
segment-sum (``np.bincount``) over these arrays.  :class:`BasePlan` is the plan
protocol carried by the IR: ``(table, sigma)`` plus the dict accessors
(``plan.sigmas[A]``) as thin views over the arrays.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import weakref
from collections import OrderedDict
from collections.abc import Mapping as _MappingABC
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .domain import Clique, Domain, MarginalWorkload, closure, subsets

_SIGMA_MAX = 1e300   # sliver clamp: zero-weight cliques never overflow to inf


def _encode(mat: np.ndarray, base: int) -> np.ndarray:
    """Order-preserving int64 key of sorted-attribute rows (fixed width).

    Rows of ``mat`` are cliques of one size class; the polynomial-in-``base``
    key sorts exactly like the clique tuples, so per-size ``np.unique`` /
    ``searchsorted`` reproduce the (len, lex) closure order.
    """
    key = np.zeros(mat.shape[0], dtype=np.int64)
    for j in range(mat.shape[1]):
        key = key * base + mat[:, j]
    return key


def _group_by_len(cliques: Sequence[Clique]):
    """{k: (workload row indices, (g, k) attr-index matrix)}.

    Vectorized: one ``fromiter`` pass over the flattened attribute stream and
    one over the lengths, then per-size row gathers — no per-clique Python
    appends (the historical append loop dominated ``build`` at d=100).
    """
    m = len(cliques)
    lens = np.fromiter(map(len, cliques), np.int64, count=m)
    flat = np.fromiter(itertools.chain.from_iterable(cliques), np.int64,
                       count=int(lens.sum()))
    starts = np.concatenate([np.zeros(1, np.int64), np.cumsum(lens)])
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for k in map(int, np.unique(lens)):
        ridx = np.nonzero(lens == k)[0]
        mat = flat[starts[ridx][:, None] + np.arange(k, dtype=np.int64)] \
            if k else np.zeros((len(ridx), 0), np.int64)
        out[k] = (ridx, mat)
    return out


@dataclass(eq=False)
class PlanTable:
    """Flat arrayized closure of one workload (built once, queried many times).

    The closure is stored as per-size attribute matrices (``_members``,
    ``_offsets``) — the tuple list ``cliques`` and the dict ``index`` are
    *lazy*: materialized (and cached) on first access.  Selection, variance
    and covariance queries run on the flat arrays alone, so a d=100 build no
    longer pays for 166k Python tuples it may never look at.
    """

    domain: Domain
    workload: MarginalWorkload
    n_closure: int                   # closure size
    p: np.ndarray                    # (n,) pcost coefficients (Thm 3 / Thm 7)
    weights: np.ndarray              # (m,) workload importance Imp_A
    wk_index: np.ndarray             # (m,) closure index of each workload clique
    inc_rows: np.ndarray             # (nnz,) workload row
    inc_cols: np.ndarray             # (nnz,) closure col
    inc_vals: np.ndarray             # (nnz,) unweighted variance coefficients
    v: np.ndarray                    # (n,) default-weight SoV coefficients
    axis_pcost: np.ndarray
    axis_meas: np.ndarray
    axis_marg: np.ndarray
    axis_cross: Optional[np.ndarray]  # None for RP+ tables (plain-only queries)
    plain: bool
    _members: Optional[Dict[int, np.ndarray]] = field(default=None, repr=False)
    _offsets: Optional[Dict[int, int]] = field(default=None, repr=False)
    _cliques: Optional[List[Clique]] = field(default=None, repr=False)
    _index: Optional[Dict[Clique, int]] = field(default=None, repr=False)
    _device: Dict[str, tuple] = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------ dimensions
    @property
    def n(self) -> int:
        """Closure size (number of base mechanisms)."""
        return self.n_closure

    @property
    def m(self) -> int:
        """Workload size (number of marginal queries)."""
        return len(self.workload.cliques)

    # -------------------------------------------------- lazy clique material
    @property
    def cliques(self) -> List[Clique]:
        """Closure as (len, lex)-sorted tuples (materialized on first use)."""
        if self._cliques is None:
            cl: List[Clique] = []
            for s in sorted(self._members):
                cl.extend(map(tuple, self._members[s].tolist()))
            self._cliques = cl
        return self._cliques

    @property
    def index(self) -> Dict[Clique, int]:
        """Clique → closure position (materialized on first use)."""
        if self._index is None:
            self._index = {c: i for i, c in enumerate(self.cliques)}
        return self._index

    # -------------------------------------------------------------- builders
    @staticmethod
    def build(workload: MarginalWorkload, *, axis_pcost: np.ndarray,
              axis_meas: np.ndarray, axis_marg: np.ndarray,
              axis_cross: Optional[np.ndarray] = None,
              plain: bool = True) -> "PlanTable":
        """Build the IR from per-axis factor vectors.

        A clique's pcost coefficient is ``Π_{i∈A} axis_pcost[i]`` and the
        variance coefficient of σ²_{A'} in the marginal on A is
        ``Π_{i∈A'} axis_meas[i] · Π_{i∈A∖A'} axis_marg[i]`` — both Thm 4 and
        Thm 8 factor per axis, which is what makes the IR exact for plain
        and RP+ plans alike.
        """
        dom = workload.domain
        wk = workload.cliques
        if not wk:
            raise ValueError("empty workload")
        m = len(wk)
        base = max(dom.n_attrs, 2)
        groups = _group_by_len(wk)
        kmax = max(groups)
        weights = workload.weight_array()
        if kmax * math.log2(base) > 62:   # huge cliques: dict closure (rare)
            return PlanTable._build_dict(workload, weights, axis_pcost,
                                         axis_meas, axis_marg, axis_cross,
                                         plain)

        # Single pass over (size-class, subset-mask): the encoded key, the
        # Π axis_meas (selected) and Π axis_marg (unselected) products are
        # each a mask-DP reusing the mask-minus-highest-bit value — no
        # re-encoding, no fancy-index ``np.prod`` gathers per mask.  The
        # closure AND the incidence columns then come out of ONE
        # ``np.unique(..., return_inverse=True)`` per subset size.
        cand: Dict[int, list] = {}
        for k, (ridx, mat) in sorted(groups.items()):
            nk = len(mat)
            meas_col = [axis_meas[mat[:, j]] for j in range(k)]
            marg_col = [axis_marg[mat[:, j]] for j in range(k)]
            key_dp = [np.zeros(nk, np.int64)] + [None] * ((1 << k) - 1)
            meas_dp = [np.ones(nk)] + [None] * ((1 << k) - 1)
            marg_dp = [np.ones(nk)] + [None] * ((1 << k) - 1)
            full = (1 << k) - 1
            for mask in range(1, 1 << k):
                hb = mask.bit_length() - 1
                rest = mask ^ (1 << hb)
                key_dp[mask] = key_dp[rest] * base + mat[:, hb]
                meas_dp[mask] = meas_dp[rest] * meas_col[hb]
                marg_dp[mask] = marg_dp[rest] * marg_col[hb]
            for mask in range(1 << k):
                s = bin(mask).count("1")
                sel = [j for j in range(k) if mask >> j & 1]
                cand.setdefault(s, []).append(
                    (key_dp[mask], ridx, meas_dp[mask] * marg_dp[full ^ mask],
                     mat[:, sel], mask == full))

        nnz = sum(len(e[0]) for ch in cand.values() for e in ch)
        inc_rows = np.empty(nnz, np.int64)
        inc_cols = np.empty(nnz, np.int64)
        inc_vals = np.empty(nnz)
        wk_index = np.empty(m, np.int64)
        members: Dict[int, np.ndarray] = {}
        offsets: Dict[int, int] = {}
        p_segs: List[np.ndarray] = []
        n = pos = 0
        for s in sorted(cand):
            chunks = cand[s]
            keys = np.concatenate([c[0] for c in chunks])
            uk, first, inv = np.unique(keys, return_index=True,
                                       return_inverse=True)
            offsets[s] = n
            members[s] = np.concatenate([c[3] for c in chunks], axis=0)[first]
            p_segs.append(np.prod(axis_pcost[members[s]], axis=1)
                          if s else np.ones(len(uk)))
            cols = n + inv
            at = 0
            for _keys, ridx, vals, _sub, is_full in chunks:
                g = len(ridx)
                sl = slice(pos, pos + g)
                inc_rows[sl] = ridx
                inc_cols[sl] = cols[at:at + g]
                inc_vals[sl] = vals
                if is_full:
                    wk_index[ridx] = cols[at:at + g]
                pos += g
                at += g
            n += len(uk)
        p = np.concatenate(p_segs)
        v = np.bincount(inc_cols, weights=weights[inc_rows] * inc_vals,
                        minlength=n)
        return PlanTable(dom, workload, n, p, weights, wk_index,
                         inc_rows, inc_cols, inc_vals, v, axis_pcost,
                         axis_meas, axis_marg, axis_cross, plain,
                         _members=members, _offsets=offsets)

    @staticmethod
    def _build_dict(workload, weights, axis_pcost, axis_meas, axis_marg,
                    axis_cross, plain) -> "PlanTable":
        """Fallback for cliques too wide for int64 keys: dict closure."""
        dom = workload.domain
        wk = workload.cliques
        cliques = closure(wk)
        index = {c: i for i, c in enumerate(cliques)}
        n = len(cliques)
        p = np.ones(n)
        for i, c in enumerate(cliques):
            p[i] = float(np.prod(axis_pcost[list(c)])) if c else 1.0
        rows_l, cols_l, vals_l = [], [], []
        wk_index = np.empty(len(wk), np.int64)
        for r, wc in enumerate(wk):
            wk_index[r] = index[wc]
            for sub in subsets(wc):
                rows_l.append(r)
                cols_l.append(index[sub])
                rest = [i for i in wc if i not in set(sub)]
                val = float(np.prod(axis_meas[list(sub)])) if sub else 1.0
                if rest:
                    val *= float(np.prod(axis_marg[rest]))
                vals_l.append(val)
        inc_rows = np.asarray(rows_l, np.int64)
        inc_cols = np.asarray(cols_l, np.int64)
        inc_vals = np.asarray(vals_l)
        v = np.bincount(inc_cols, weights=weights[inc_rows] * inc_vals,
                        minlength=n)
        table = PlanTable(dom, workload, n, p, weights, wk_index,
                          inc_rows, inc_cols, inc_vals, v, axis_pcost,
                          axis_meas, axis_marg, axis_cross, plain)
        table._cliques = cliques
        table._index = index
        return table

    @staticmethod
    def for_workload(workload: MarginalWorkload) -> "PlanTable":
        """Plain-marginal IR: Thm 3/4 per-axis factors from the domain sizes."""
        from .residual import axis_coeff_vectors
        pc, meas, marg, cross = axis_coeff_vectors(workload.domain)
        return PlanTable.build(workload, axis_pcost=pc, axis_meas=meas,
                               axis_marg=marg, axis_cross=cross, plain=True)

    # ------------------------------------------------------------- weighting
    def weight_vector(self, weights: Optional[Mapping[Clique, float]] = None,
                      default_to_workload: bool = True) -> np.ndarray:
        """Importance per workload row under an optional override mapping.

        ``default_to_workload`` keeps the two historical conventions apart:
        the SoV coefficient path defaulted missing cliques to 1.0, the
        maxvar/convex paths to ``workload.weight``.
        """
        if weights is None:
            return self.weights
        if default_to_workload:
            return np.array([float(weights.get(c, self.workload.weight(c)))
                             for c in self.workload.cliques])
        return np.array([float(weights.get(c, 1.0))
                         for c in self.workload.cliques])

    def sov_coeffs(self, weights: Optional[Mapping[Clique, float]] = None
                   ) -> np.ndarray:
        """SoV coefficients v_A (§6.1) under optional weight override."""
        if weights is None:
            return self.v
        w = self.weight_vector(weights, default_to_workload=False)
        return np.bincount(self.inc_cols,
                           weights=w[self.inc_rows] * self.inc_vals,
                           minlength=self.n)

    # --------------------------------------------------------------- queries
    def pcost(self, sigma: np.ndarray) -> float:
        """Σ_A p_A / σ²_A (Thm 3)."""
        return float(np.sum(self.p / sigma))

    def variances(self, sigma: np.ndarray) -> np.ndarray:
        """Variance of EVERY workload marginal in one segment-sum (Thm 4/8).

        Plain tables: per-cell variance of each reconstructed marginal.
        RP+ tables: SoV (cell-sum) of each generalized query — the Thm 8
        convention.
        """
        sigma = np.asarray(sigma, np.float64)
        return np.bincount(self.inc_rows,
                           weights=self.inc_vals * sigma[self.inc_cols],
                           minlength=self.m)

    def variance_of(self, sigma: np.ndarray, clique: Clique) -> float:
        """Single-marginal variance for any clique inside the closure."""
        am, ag = self.axis_meas, self.axis_marg
        out = 0.0
        for sub in subsets(clique):
            coef = float(np.prod(am[list(sub)])) if sub else 1.0
            rest = [i for i in clique if i not in set(sub)]
            if rest:
                coef *= float(np.prod(ag[rest]))
            out += coef * float(sigma[self.index[sub]])
        return out

    def covariance_coeffs(self, a: Clique, b: Clique
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """(closure cols, coefficients) of the aligned-cell covariance of
        reconstructed marginals A and B (the Thm-4 machinery extended across
        marginals; plain tables only).

        Cov(Q̂_A[u], Q̂_B[w]) for cells agreeing on A∩B is
        ``Σ_{A'⊆A∩B} σ²_{A'} · Π_{i∈A'} (1−1/n_i) · Π_{i∈(A∩B)∖A'} 1/n_i²
        · Π_{i∈AΔB} 1/n_i`` — only the shared measurements correlate.
        """
        if self.axis_cross is None:
            raise ValueError("cross-marginal covariance requires a plain "
                             "(identity-basis) PlanTable")
        inter = tuple(sorted(set(a) & set(b)))
        symdiff = sorted(set(a) ^ set(b))
        outer = float(np.prod(self.axis_cross[symdiff])) if symdiff else 1.0
        cols, coefs = [], []
        for sub in subsets(inter):
            coef = outer
            if sub:
                coef *= float(np.prod(self.axis_meas[list(sub)]))
            rest = [i for i in inter if i not in set(sub)]
            if rest:
                coef *= float(np.prod(self.axis_marg[rest]))
            cols.append(self.index[sub])
            coefs.append(coef)
        return np.asarray(cols, np.int64), np.asarray(coefs)

    def cross_covariance(self, sigma: np.ndarray, a: Clique, b: Clique) -> float:
        cols, coefs = self.covariance_coeffs(a, b)
        return float(np.dot(coefs, np.asarray(sigma, np.float64)[cols]))

    def cross_covariances(self, sigma: np.ndarray,
                          pairs: Sequence[Tuple[Clique, Clique]]) -> np.ndarray:
        """Aligned-cell covariance for a batch of marginal pairs: the COO rows
        of all pairs concatenate into ONE segment-sum."""
        sigma = np.asarray(sigma, np.float64)
        rows_l, cols_l, vals_l = [], [], []
        for r, (a, b) in enumerate(pairs):
            cols, coefs = self.covariance_coeffs(a, b)
            rows_l.append(np.full(len(cols), r, np.int64))
            cols_l.append(cols)
            vals_l.append(coefs)
        if not rows_l:
            return np.zeros(0)
        rows = np.concatenate(rows_l)
        return np.bincount(rows,
                           weights=np.concatenate(vals_l)
                           * sigma[np.concatenate(cols_l)],
                           minlength=len(pairs))

    def device_arrays(self, device=None):
        """(p, inc_rows, inc_cols, inc_vals) as torch tensors on ``device``
        (float64 values, int64 indices), cached per device."""
        import torch
        from repro_torch.kernels.kron_matvec._layout import resolve_device
        dev = resolve_device(device)
        key = str(dev)
        ent = self._device.get(key)
        if ent is None:
            ent = (torch.as_tensor(self.p, dtype=torch.float64, device=dev),
                   torch.as_tensor(self.inc_rows, device=dev),
                   torch.as_tensor(self.inc_cols, device=dev),
                   torch.as_tensor(self.inc_vals, dtype=torch.float64,
                                   device=dev))
            self._device[key] = ent
        return ent

    def device_segments(self, device=None):
        """(rows, cols): the incidence as two
        :class:`~repro_torch.core.segment.Segments` on ``device``, the
        workload rows and the closure columns of its entries; cached per
        device.  Sums over them add in an order fixed by the data, on CUDA
        too (``index_add_`` does not)."""
        from .segment import Segments
        _p, rows, cols, _v = self.device_arrays(device)
        key = "segments:" + str(rows.device)
        ent = self._device.get(key)
        if ent is None:
            ent = (Segments(rows, self.m), Segments(cols, self.n))
            self._device[key] = ent
        return ent


# ---------------------------------------------------------------------------
# Closed-form SoV (Lemma 2) — shared by plain and RP+ selection
# ---------------------------------------------------------------------------

def sov_closed_form(p: np.ndarray, v: np.ndarray, pcost_budget: float
                    ) -> np.ndarray:
    """σ²_A = (Σ √(p v))·√(p_A/v_A)/c — the Lemma 2 optimum, overflow-safe.

    Cliques with v_A == 0 (needed for reconstruction completeness, zero
    objective weight) get a 1e-9 sliver of the budget each, computed in a
    factorization that cannot overflow to inf for tiny budgets (the historic
    ``p/eps_share`` sliver hit inf once ``eps_share`` went denormal); the
    sliver σ² is additionally clamped at 1e300.
    """
    c = float(pcost_budget)
    if not c > 0:
        raise ValueError(f"pcost budget must be positive, got {c}")
    pos = v > 0
    n_zero = int((~pos).sum())
    eps_frac = 1e-9 if n_zero else 0.0          # budget fraction per sliver
    c_eff = c * (1.0 - eps_frac * n_zero)
    sig = np.zeros(len(v))
    ssum = float(np.sqrt(v[pos] * p[pos]).sum())
    # σ = (S/c_eff)·√(p/v): no S²/c intermediate, stable down to c ~ 1e-300.
    sig[pos] = (ssum / c_eff) * np.sqrt(p[pos] / v[pos])
    if n_zero:
        with np.errstate(over="ignore", divide="ignore"):
            sliver = p[~pos] / (eps_frac * c)
        sig[~pos] = np.minimum(sliver, _SIGMA_MAX)
        total = float(np.sum(p / sig))
        if total > c:       # clamp bound: rescale so pcost ≤ budget exactly
            sig *= total / c
    return sig


# ---------------------------------------------------------------------------
# The unified plan protocol
# ---------------------------------------------------------------------------

class SigmaView(_MappingABC):
    """``Dict[Clique, float]`` view over the σ² array (legacy accessor)."""

    __slots__ = ("_table", "_sigma")

    def __init__(self, table: PlanTable, sigma: np.ndarray):
        self._table = table
        self._sigma = sigma

    def __getitem__(self, clique: Clique) -> float:
        return float(self._sigma[self._table.index[clique]])

    def __iter__(self):
        return iter(self._table.cliques)

    def __len__(self) -> int:
        return len(self._table.cliques)


@dataclass(eq=False)
class BasePlan:
    """What every selection output is: an IR + a σ² vector over its closure.

    ``Plan`` (plain marginals) and ``PlusPlan`` (generalized bases) both
    subclass this; engines and the measurement/reconstruction layers consume
    only this protocol — ``domain``, ``cliques``, ``sigmas``/``sigma2`` and
    ``engine()`` — so no caller branches on the concrete plan type.
    """

    table: PlanTable
    sigma: np.ndarray            # (n_closure,) σ²_A in table.cliques order
    objective: str
    pcost: float
    loss_value: float

    @property
    def domain(self) -> Domain:
        return self.table.domain

    @property
    def workload(self) -> MarginalWorkload:
        return self.table.workload

    @property
    def cliques(self) -> List[Clique]:
        return self.table.cliques

    @property
    def sigmas(self) -> SigmaView:
        return SigmaView(self.table, self.sigma)

    def sigma2(self, clique: Clique) -> float:
        return float(self.sigma[self.table.index[clique]])

    def variances_array(self) -> np.ndarray:
        """Per-workload-marginal variance, one segment-sum (Thm 4/8)."""
        return self.table.variances(self.sigma)

    def workload_variances(self) -> Dict[Clique, float]:
        return dict(zip(self.workload.cliques,
                        map(float, self.variances_array())))

    def engine(self, use_kernel=None, precompile: bool = True, dtype=None,
               secure: bool = False, digits: int = 4, device=None):
        """The measurement/reconstruction engine serving this plan family
        (``secure=True``: the discrete release at ``digits`` σ̄ digits)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Memoized table per workload (built once, shared by all selectors)
# ---------------------------------------------------------------------------

_TABLE_CACHE: "OrderedDict[int, PlanTable]" = OrderedDict()
_TABLE_CACHE_MAX = 64


def plan_table(workload: MarginalWorkload) -> PlanTable:
    """The plain-marginal PlanTable of a workload, built once per object.

    LRU-bounded (single-entry eviction, never a wholesale clear) and
    identity-validated on every hit, so a recycled ``id`` can never return a
    stale table.  Cached tables pin their workload (``table.workload``), so
    entries normally leave via LRU eviction; the ``weakref.finalize`` is a
    belt-and-braces cleanup for ids freed after eviction.
    """
    key = id(workload)
    t = _TABLE_CACHE.get(key)
    if t is not None and t.workload is workload:
        _TABLE_CACHE.move_to_end(key)
        return t
    t = PlanTable.for_workload(workload)
    while len(_TABLE_CACHE) >= _TABLE_CACHE_MAX:
        _TABLE_CACHE.popitem(last=False)
    _TABLE_CACHE[key] = t
    with contextlib.suppress(TypeError):
        weakref.finalize(workload, _TABLE_CACHE.pop, key, None)
    return t
