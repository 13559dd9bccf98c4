r"""ResidualPlanner+ (Section 7): generalized marginals beyond identity queries.

The port's copy of ``repro.core.plus``.  Every attribute i carries a *basic
matrix* W_i (identity / prefix-sum / range / custom; the only requirement is
that 1ᵀ lies in W_i's row space) and an optional *strategy replacement* S_i
with row space ⊇ row space of W_i.  Algorithm 4 builds a generalized
subtraction matrix Sub_i whose rows span the part of S_i's row space
orthogonal to 1, plus a noise factor Γ_i:

    identity attribute:  Sub_i = Sub_{n}   (Section 4.2),  Γ_i = Sub_i
    otherwise:           P₁ = S_i - S_i 11ᵀ/n,  P₁ᵀP₁ = L Lᵀ (eigh-based
                         factorization; Cholesky is rank-deficient here),
                         Sub_i = P₂ᵀ (independent columns of L),  Γ_i = I.

The bases, the Thm 7/8 coefficients, the SoV selection and the float64
oracles of Algorithms 5 and 6 are host numpy, as in the reference.  The
max-variance solver runs its Adam loop in torch on the resolved device, and
``strategy_mode="auto"`` runs the p-Identity optimizer
(:mod:`repro_torch.baselines.hdmm`) there too.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.kron_matvec._layout import resolve_device

from .domain import Clique, Domain, MarginalWorkload, subsets
from .kron import kron_matvec_np
from .mechanism import Measurement, signature_groups
from .plantable import BasePlan, PlanTable, sov_closed_form
from .reconstruct import subset_slot_region
from .residual import sub_matrix, sub_pinv
from .segment import Segments

# ---------------------------------------------------------------------------
# Basic (workload) matrices
# ---------------------------------------------------------------------------


def w_identity(n: int) -> np.ndarray:
    return np.eye(n)


def w_prefix(n: int) -> np.ndarray:
    """All prefix sums: row i answers 'value <= i' (lower-triangular ones)."""
    return np.tril(np.ones((n, n)))


def w_range(n: int) -> np.ndarray:
    """All n(n+1)/2 contiguous ranges [a, b]."""
    rows = []
    for a in range(n):
        for b in range(a, n):
            r = np.zeros(n)
            r[a:b + 1] = 1.0
            rows.append(r)
    return np.array(rows)


def w_total(n: int) -> np.ndarray:
    return np.ones((1, n))


def build_w(kind: str, n: int) -> np.ndarray:
    return {"identity": w_identity, "prefix": w_prefix,
            "range": w_range, "total": w_total}[kind](n)


def classify_w(W: np.ndarray) -> str:
    """Structural kind of a basic matrix: identity | prefix | range | total | custom.

    The engine (engine/plus_engine.py) uses the kind to apply W_i
    *implicitly* — prefix as a cumsum epilogue, range as cumsum +
    prefix-difference — so the O(n²)-row ``w_range`` never enters a dense
    matvec on the hot path.  Detection is structural, so a custom-passed
    matrix that happens to be a prefix/range matrix still gets the implicit
    path.
    """
    W = np.asarray(W)
    m, n = W.shape
    if m == 1 and np.array_equal(W, np.ones((1, n))):
        return "total"
    if m == n:
        if np.array_equal(W, np.eye(n)):
            return "identity"
        if np.array_equal(W, np.tril(np.ones((n, n)))):
            return "prefix"
    if m == n * (n + 1) // 2 and np.array_equal(W, w_range(n)):
        return "range"
    return "custom"


def s_hierarchical(n: int, branching: int = 2) -> np.ndarray:
    """Hierarchical (H-tree) strategy: identity leaves + interval sums per level.

    A classic strategy replacement for range/prefix workloads [Hay et al.].
    """
    rows = [np.eye(n)]
    width = branching
    while width < n:
        lvl = np.zeros(((n + width - 1) // width, n))
        for j in range(lvl.shape[0]):
            lvl[j, j * width:(j + 1) * width] = 1.0
        rows.append(lvl)
        width *= branching
    rows.append(np.ones((1, n)))
    return np.vstack(rows)


# ---------------------------------------------------------------------------
# Algorithm 4: generalized subtraction matrices
# ---------------------------------------------------------------------------

@dataclass
class AttrBasis:
    """Per-attribute generalized residual data for ResidualPlanner+."""

    n: int
    W: np.ndarray                # basic matrix (rows x n)
    S: np.ndarray                # strategy replacement
    Sub: np.ndarray              # generalized subtraction matrix (r x n), Sub·1 = 0
    Gamma: np.ndarray            # noise factor; cov factor = Γ Γᵀ
    identity: bool
    beta: float                  # max diag of Subᵀ (ΓΓᵀ)⁻¹ Sub  (Thm 7)
    sub_pinv: np.ndarray         # Sub^† (n x r)
    kind: str = "custom"         # classify_w(W): drives the implicit-W epilogue

    @property
    def fnorm2(self) -> float:
        """‖W Sub† Γ‖_F² — the measured-part variance factor in Thm 8."""
        return float(np.linalg.norm(self.W @ self.sub_pinv @ self.Gamma, ord="fro") ** 2)

    @property
    def wones2(self) -> float:
        """‖W 1‖² / n² — the marginalized-part variance factor in Thm 8."""
        return float(np.linalg.norm(self.W @ np.ones(self.n)) ** 2) / self.n ** 2


def attr_basis(W: np.ndarray, S: Optional[np.ndarray] = None,
               tol: float = 1e-9) -> AttrBasis:
    W = np.asarray(W, dtype=np.float64)
    n = W.shape[1]
    S = W if S is None else np.asarray(S, dtype=np.float64)
    # sanity: 1ᵀ must be in the row space of W (paper's only restriction).
    ones = np.ones(n)
    resid = ones - W.T @ np.linalg.lstsq(W.T, ones, rcond=None)[0]
    if np.linalg.norm(resid) > 1e-6 * math.sqrt(n):
        raise ValueError("1ᵀ is not in the row space of W")
    is_identity = W.shape == (n, n) and np.allclose(W, np.eye(n))
    if is_identity and S is W:
        Sub = sub_matrix(n)
        Gamma = Sub.copy()
        spinv = sub_pinv(n)
        gram_inv = np.linalg.inv(Sub @ Sub.T)
        beta = float(np.max(np.diag(Sub.T @ gram_inv @ Sub)))
        return AttrBasis(n, W, S, Sub, Gamma, True, beta, spinv, kind="identity")
    # Algorithm 4 general branch (eigh replaces rank-deficient Cholesky).
    P1 = S - (S @ np.ones((n, 1))) @ np.ones((1, n)) / n
    M = P1.T @ P1
    evals, evecs = np.linalg.eigh(M)
    keep = evals > tol * max(evals.max(), 1.0)
    L = evecs[:, keep] * np.sqrt(evals[keep])          # M = L Lᵀ
    Sub = L.T                                          # rows span rowspace(P1), ⟂ 1
    Gamma = np.eye(Sub.shape[0])
    spinv = np.linalg.pinv(Sub)
    beta = float(np.max(np.einsum("ij,ij->j", Sub, Sub)))   # Γ=I ⇒ diag SubᵀSub
    return AttrBasis(n, W, S, Sub, Gamma, False, beta, spinv, kind=classify_w(W))


@dataclass
class PlusSchema:
    """Domain + per-attribute (W_i, S_i) bases for ResidualPlanner+."""

    domain: Domain
    bases: Tuple[AttrBasis, ...]

    @staticmethod
    def create(domain: Domain, kinds: Sequence[str],
               strategies: Optional[Sequence[Optional[np.ndarray]]] = None,
               strategy_mode: str = "auto", device=None) -> "PlusSchema":
        """kinds[i] ∈ {identity, prefix, range, total}; strategy_mode ∈
        {w (S=W), hier, auto (p-Identity optimizer, as in the paper §9)}.

        ``device`` is where ``"auto"`` runs the optimizer: CUDA unless
        ``device="cpu"``; it is resolved (and raises without CUDA) in every
        mode.
        """
        dev = resolve_device(device)
        bases = []
        for i, attr in enumerate(domain.attributes):
            W = build_w(kinds[i], attr.size)
            S = None if strategies is None else strategies[i]
            if S is None and kinds[i] != "identity":
                if strategy_mode == "hier":
                    S = s_hierarchical(attr.size)
                elif strategy_mode == "auto":
                    from repro_torch.baselines.hdmm import \
                        opt_pidentity_projected
                    S = opt_pidentity_projected(W, device=dev)
                # "w": S stays None -> W
            bases.append(attr_basis(W, S))
        return PlusSchema(domain, tuple(bases))

    def residual_size(self, clique: Clique) -> int:
        out = 1
        for i in clique:
            out *= self.bases[i].Sub.shape[0]
        return out

    def query_rows(self, clique: Clique) -> int:
        out = 1
        for i in clique:
            out *= self.bases[i].W.shape[0]
        return out


# ---------------------------------------------------------------------------
# pcost / variance coefficients (Thms 7 & 8) and selection
# ---------------------------------------------------------------------------

def p_coeff_plus(schema: PlusSchema, clique: Clique) -> float:
    out = 1.0
    for i in clique:
        out *= schema.bases[i].beta
    return out


def sov_coeff_plus(schema: PlusSchema, sub_clique: Clique, clique: Clique) -> float:
    """Coefficient of σ²_{A'} in SoV(Q_Ã) (Thm 8)."""
    if not set(sub_clique) <= set(clique):
        raise ValueError("not a subset")
    out = 1.0
    for i in sub_clique:
        out *= schema.bases[i].fnorm2
    for j in set(clique) - set(sub_clique):
        out *= schema.bases[j].wones2
    return out


def _cell_diag(schema: PlusSchema, sub: Clique, clique: Clique) -> np.ndarray:
    """diag(⊗_i Ψ_i Ψ_iᵀ) of subset ``sub``'s term in the answer to ``clique``."""
    diag = np.ones(1)
    for i in clique:
        b = schema.bases[i]
        if i in set(sub):
            psi = b.W @ b.sub_pinv @ b.Gamma
        else:
            psi = (b.W @ np.ones((b.n, 1))) / b.n
        diag = np.kron(diag, np.einsum("ij,ij->i", psi, psi))
    return diag


def cell_variances_plus(schema: PlusSchema, sigmas: Mapping[Clique, float],
                        clique: Clique) -> np.ndarray:
    """Exact per-cell variance vector of the reconstructed answer to Q_Ã.

    diag(⊗_i Ψ_i Ψ_iᵀ) = ⊗_i diag(Ψ_i Ψ_iᵀ): per-axis diagonal vectors kron'd.
    """
    out = np.zeros(schema.query_rows(clique))
    for sub in subsets(clique):
        out += sigmas[sub] * _cell_diag(schema, sub, clique)
    return out


@dataclass(eq=False)
class PlusPlan(BasePlan):
    """A ResidualPlanner+ plan: the unified IR protocol plus the schema.

    ``table`` carries the Thm-7/8 per-axis factors (β_i, ‖W Sub†Γ‖²_F,
    ‖W1‖²/n²), so every SoV/variance query is the same segment-sum the plain
    path uses; ``plan.sigmas[A]`` stays a thin dict view.
    """

    schema: PlusSchema = None

    def sov(self, clique: Clique) -> float:
        return self.table.variance_of(self.sigma, clique)

    def rmse(self) -> float:
        tot = float(self.variances_array().sum())
        cells = sum(self.schema.query_rows(c) for c in self.workload.cliques)
        return math.sqrt(tot / cells)

    def max_cell_variance(self) -> float:
        return max(float(cell_variances_plus(self.schema, self.sigmas, c).max())
                   for c in self.workload.cliques)

    def engine(self, use_kernel=None, precompile: bool = True, dtype=None,
               secure: bool = False, digits: int = 4, device=None):
        if secure:
            raise ValueError("secure release (Alg 3) requires a plain "
                             "identity-basis plan; RP+ plans have no "
                             "integer-query rotation")
        from repro_torch.engine.plus_engine import PlusEngine
        return PlusEngine(self, use_kernel=use_kernel, precompile=precompile,
                          dtype=dtype, device=device)


def plus_axis_vectors(schema: PlusSchema
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-attribute (β, ‖W Sub†Γ‖²_F, ‖W1‖²/n²) vectors for the IR (Thm 7/8)."""
    beta = np.array([b.beta for b in schema.bases])
    fn2 = np.array([b.fnorm2 for b in schema.bases])
    wo2 = np.array([b.wones2 for b in schema.bases])
    return beta, fn2, wo2


def plan_table_plus(workload: MarginalWorkload, schema: PlusSchema) -> PlanTable:
    """The RP+ PlanTable: same IR, Thm-7/8 per-axis coefficient vectors."""
    beta, fn2, wo2 = plus_axis_vectors(schema)
    return PlanTable.build(workload, axis_pcost=beta, axis_meas=fn2,
                           axis_marg=wo2, axis_cross=None, plain=False)


def _maxvar_adam(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 p: torch.Tensor, m: int, theta: torch.Tensor, tau0: float,
                 steps: int, lr: float) -> torch.Tensor:
    """The reference's smoothed max-variance Adam loop (``lax.scan`` there),
    step by step in the same order.

    The contraction ``var = segment_sum(vals * u[cols], rows)`` adds on the
    CPU with ``index_add_``, in input order as JAX's ``segment_sum`` does.
    On CUDA ``index_add_`` and the backward of the ``u[cols]`` gather add
    with atomics in no fixed order, and the last iterate's loss depends on
    that order by about the ±0.2% the reference's own iterates wander; so
    the card contracts through :class:`~repro_torch.core.segment.Segments`
    over ``rows`` and over ``cols``, forward and gradient alike: one input
    gives the same σ bit for bit on every call.
    """
    if rows.device.type == "cuda":
        rseg, cseg = Segments(rows, m), Segments(cols, theta.numel())

        def contract(u):
            return rseg.sum(vals * cseg.gather(u))
    else:
        def contract(u):
            return torch.zeros(m, dtype=vals.dtype, device=vals.device
                               ).index_add_(0, rows, vals * u[cols])

    def smooth_obj(th, tau):
        u = torch.exp(th)
        var = contract(u)
        L = tau * torch.logsumexp(var / tau, dim=0)
        return torch.log(torch.sum(p / u)) + torch.log(L)

    mo = torch.zeros_like(theta)
    ve = torch.zeros_like(theta)
    for i in range(steps):
        tau = tau0 * 10.0 ** (-3.0 * i / steps)
        th = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(smooth_obj(th, tau), th)
        mo = 0.9 * mo + 0.1 * g
        ve = 0.999 * ve + 0.001 * g * g
        mh = mo / (1 - 0.9 ** (i + 1.0))
        vh = ve / (1 - 0.999 ** (i + 1.0))
        theta = theta - lr * mh / (torch.sqrt(vh) + 1e-9)
    return theta.detach()


def select_plus(workload: MarginalWorkload, schema: PlusSchema,
                pcost_budget: float = 1.0, objective: str = "sum_of_variances",
                weights: Optional[Mapping[Clique, float]] = None,
                steps: int = 3000, lr: float = 0.05,
                table: Optional[PlanTable] = None, device=None) -> PlusPlan:
    """Selection for RP+ workloads.  SoV is closed form (Lemma 2 applies verbatim
    with generalized p_A, v_A, both straight off the IR); max_variance uses the
    scale-invariant solver on the exact per-cell variance diagonals, in float32
    on ``device`` (CUDA unless ``device="cpu"``; resolved for every objective).
    """
    dev = resolve_device(device)
    table = plan_table_plus(workload, schema) if table is None else table
    cl = table.cliques
    index = table.index
    p = table.p
    if weights is None:
        v = table.v
    else:
        w = table.weight_vector(weights, default_to_workload=True)
        v = np.bincount(table.inc_cols,
                        weights=w[table.inc_rows] * table.inc_vals,
                        minlength=table.n)

    if objective in ("sum_of_variances", "sov", "rmse"):
        sig = sov_closed_form(p, v, pcost_budget)
        return PlusPlan(table, sig, objective, pcost=table.pcost(sig),
                        loss_value=float(np.dot(v, sig)), schema=schema)

    if objective in ("max_variance", "maxvar"):
        # Per-cell variance rows: Var_cell = D u with D (total_cells x |closure|).
        rows, cols, vals = [], [], []
        row0 = 0
        for wc in workload.cliques:
            imp = float((weights or {}).get(wc, workload.weight(wc)))
            ncells = schema.query_rows(wc)
            for sub in subsets(wc):
                diag = _cell_diag(schema, sub, wc)
                for r in range(ncells):
                    if diag[r] != 0.0:
                        rows.append(row0 + r)
                        cols.append(index[sub])
                        vals.append(diag[r] / imp)
            row0 += ncells
        f32 = dict(dtype=torch.float32, device=dev)
        warm_sig = np.sqrt(np.maximum(p, 1e-12) / np.maximum(v, 1e-12))
        warm_sig *= float(np.sum(p / warm_sig))  # normalize pcost to 1 then scale
        theta0 = torch.log(torch.as_tensor(warm_sig / pcost_budget, **f32))
        tau0 = float(np.median(vals)) * float(torch.exp(theta0).mean()) + 1e-12
        theta = _maxvar_adam(
            torch.as_tensor(np.array(rows, np.int64), device=dev),
            torch.as_tensor(np.array(cols, np.int64), device=dev),
            torch.as_tensor(np.array(vals), **f32), torch.as_tensor(p, **f32),
            row0, theta0, tau0, steps, lr)
        u = np.exp(theta.cpu().numpy().astype(np.float64))
        u *= float(np.sum(p / u)) / pcost_budget
        # fp64 loss at the solution, set at construction (never patched after).
        sig_map = dict(zip(cl, map(float, u)))
        loss_value = max(float(cell_variances_plus(schema, sig_map, c).max())
                         for c in workload.cliques)
        return PlusPlan(table, u, objective, pcost=table.pcost(u),
                        loss_value=loss_value, schema=schema)

    raise ValueError(objective)


# ---------------------------------------------------------------------------
# Measurement (Alg 5) and reconstruction (Alg 6): float64 host oracles
# ---------------------------------------------------------------------------

def measure_plus_np(plan: PlusPlan, marginals: Mapping[Clique, np.ndarray],
                    rng) -> Dict[Clique, Measurement]:
    out: Dict[Clique, Measurement] = {}
    schema = plan.schema
    for clique in plan.cliques:
        dims = [schema.bases[i].n for i in clique]
        v = np.asarray(marginals[clique], dtype=np.float64).reshape(-1)
        sigma = math.sqrt(plan.sigmas[clique])
        if not clique:
            out[clique] = Measurement(clique, v + sigma * rng.standard_normal(1),
                                      plan.sigmas[clique])
            continue
        h1 = [schema.bases[i].Sub for i in clique]
        h2 = [schema.bases[i].Gamma for i in clique]
        zdims = [g.shape[1] for g in h2]
        z = rng.standard_normal(int(np.prod(zdims)))
        hv = kron_matvec_np(h1, v, dims)
        hz = kron_matvec_np(h2, z, zdims)
        out[clique] = Measurement(clique, hv + sigma * hz, plan.sigmas[clique])
    return out


def reconstruct_plus(plan: PlusPlan, measurements: Mapping[Clique, Measurement],
                     clique: Clique) -> np.ndarray:
    """Algorithm 6: residual combine (as in Alg 2) then apply Ŵ = ⊗ W_i."""
    schema = plan.schema
    q = None
    for sub in subsets(clique):
        omega = np.asarray(measurements[sub].omega, dtype=np.float64).reshape(-1)
        if not clique:
            term = omega
        else:
            factors, in_dims = [], []
            for i in clique:
                b = schema.bases[i]
                if i in set(sub):
                    factors.append(b.sub_pinv)
                    in_dims.append(b.Sub.shape[0])
                else:
                    factors.append(np.full((b.n, 1), 1.0 / b.n))
                    in_dims.append(1)
            term = kron_matvec_np(factors, omega, in_dims)
        q = term if q is None else q + term
    if not clique:
        return q
    wfacs = [schema.bases[i].W for i in clique]
    return kron_matvec_np(wfacs, q, [schema.bases[i].n for i in clique])


# ---------------------------------------------------------------------------
# Chain factors for the engine
# ---------------------------------------------------------------------------

def plus_axis_token(basis: AttrBasis) -> tuple:
    """Hashable per-axis signature token for generalized batching.

    Plain marginals batch on attribute *size* because ``Sub_n`` is fully
    determined by n.  Here Γ_i ≠ Sub_i for non-identity bases and the factor
    values depend on (W_i, S_i), so the token carries the factor shapes plus
    value digests (stacking rows into one chain additionally requires equal
    factor *values* — a digest collision would silently measure cliques with
    the wrong factors, so the digest is cryptographic, not a checksum).
    Construction is deterministic, so equal (W, S) inputs yield equal tokens.
    """
    def _dig(a: np.ndarray) -> bytes:
        return hashlib.blake2b(
            np.ascontiguousarray(a, dtype=np.float64).tobytes(),
            digest_size=16).digest()

    return (basis.n, basis.kind, basis.Sub.shape, basis.Gamma.shape,
            basis.W.shape, _dig(basis.Sub), _dig(basis.Gamma), _dig(basis.W))


def plus_signature_groups(schema: PlusSchema, cliques: Sequence[Clique]
                          ) -> Dict[tuple, List[Clique]]:
    """Group cliques by generalized per-axis ``(Sub_i, Γ_i, W_i)`` signature."""
    tokens = [plus_axis_token(b) for b in schema.bases]
    return signature_groups(schema.domain, cliques,
                            axis_key=lambda i: tokens[i])


def measure_chain_split(schema: PlusSchema, clique: Clique):
    """Factors of the staged Alg 5 measurement chains.

    ω = (⊗ Sub_i) v + σ (⊗ Γ_i) z splits per axis: identity-basis axes have
    Γ_i = Sub_i (both streams share the factor), general axes have Γ_i = I
    (the noise stream skips the axis).  Stage A applies the general-axis
    ``Sub_i`` to the v rows only (input dims ``dims`` → ``zdims``); stage B
    applies the identity-axis ``Sub_i`` to the stacked [v'; z] rows at input
    dims ``zdims``.  All-identity cliques degenerate to the plain-marginal
    single chain; all-general cliques need no stage B chain at all.

    Returns ``(dims, zdims, stage_a, stage_b)``.
    """
    dims: List[int] = []
    zdims: List[int] = []
    stage_a: List[Optional[np.ndarray]] = []
    stage_b: List[Optional[np.ndarray]] = []
    for i in clique:
        b = schema.bases[i]
        dims.append(b.n)
        zdims.append(b.Gamma.shape[1])
        if b.identity:
            stage_a.append(None)
            stage_b.append(b.Sub)
        else:
            stage_a.append(b.Sub)
            stage_b.append(None)
    return dims, zdims, stage_a, stage_b


def t_chain_factors_plus(schema: PlusSchema, clique: Clique) -> List[np.ndarray]:
    """Per-axis factors T_i = [ Sub_i^† | (1/n_i)·1 ]  (n_i × (r_i+1)).

    The merged-subset identity of core/reconstruct.py generalizes verbatim:
    for every A' ⊆ A, U_{A←A'} ω_{A'} equals (⊗_{i∈A} T_i) e_{A'} with
    ω_{A'} embedded at axis-i slots 0..r_i−1 when i ∈ A' and slot r_i
    otherwise — distinct subsets occupy disjoint slot regions, so
    Algorithm 6's 2^|A| subset matvecs collapse into ONE chain.
    """
    out = []
    for i in clique:
        b = schema.bases[i]
        out.append(np.hstack([b.sub_pinv, np.full((b.n, 1), 1.0 / b.n)]))
    return out


def embed_subset_answers_plus(plan: PlusPlan,
                              measurements: Mapping[Clique, Measurement],
                              clique: Clique, dtype=np.float64) -> np.ndarray:
    """Sum of subset embeddings Σ_{A'⊆A} e_{A'} — input of the merged T-chain."""
    schema = plan.schema
    rdims = tuple(schema.bases[i].Sub.shape[0] + 1 for i in clique)
    t = np.zeros(rdims, dtype=dtype)
    for sub in subsets(clique):
        region, shape = subset_slot_region(clique, sub, rdims)
        t[region] = np.asarray(measurements[sub].omega,
                               dtype=dtype).reshape(shape)
    return t


def reconstruct_plus_merged(plan: PlusPlan,
                            measurements: Mapping[Clique, Measurement],
                            clique: Clique) -> np.ndarray:
    """Float64 oracle of the merged-chain Algorithm 6: one chain ⊗ (W_i T_i).

    Numerically identical (1e-9) to :func:`reconstruct_plus`; the engine
    (engine/plus_engine.py) runs the same merged chain batched, with
    prefix/range W_i applied implicitly instead of via the dense product.
    """
    if not clique:
        return np.asarray(measurements[()].omega, dtype=np.float64).reshape(-1)
    schema = plan.schema
    t = embed_subset_answers_plus(plan, measurements, clique)
    facs = [schema.bases[i].W @ tf
            for i, tf in zip(clique, t_chain_factors_plus(schema, clique))]
    return kron_matvec_np(facs, t.reshape(-1), t.shape)
