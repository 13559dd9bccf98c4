r"""HDMM baseline (McKenna et al. [40, 41]) in torch: the port's copy of
``repro.baselines.hdmm``.

Templates (the ones the paper benchmarks against):

* ``opt_pidentity``   — the 1-D p-Identity strategy optimizer: A(θ) = [I; B(θ)]
  with nonnegative B, columns normalized to unit L2 (so pcost(A) = 1), Adam on
  ``tr((AᵀA + 1e-9 I)⁻¹ WᵀW)``.  ResidualPlanner+ uses it to produce strategy
  replacements S_i ("the 1-dimensional optimizer included with HDMM", paper
  §9).  The Adam loop is the reference's ``lax.scan`` step by step, in
  float32, with autograd and ``torch.linalg.solve`` on the resolved device.
* ``HdmmKron``        — OPT_⊗: per-axis p-Identity on a Kronecker workload;
  unit-pcost total variance is the product of per-axis traces.  Host float64
  numpy, step for step the reference's.
* ``HdmmUnion``       — OPT_+: Cauchy–Schwarz budget split across
  sub-strategies (host float64).

Reconstruction is deliberately faithful to HDMM's *universe-sized* least
squares (x̂ = ⊗ A_i† y): :func:`hdmm_measure_reconstruct` materializes
O(Π n_i) vectors on the device and therefore hits the same wall the paper
reports (Table 3: out of memory at d = 10 for n = 10).  The same element
guard as the reference's raises ``MemoryError`` before any allocation.  Its
three chains per sub-strategy run on the port's kernels through
``fused_chain_matvec``: the fused kernel while the universe fits a block,
the per-axis kernel beyond.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.domain import Clique, Domain, MarginalWorkload
from repro_torch.kernels.kron_matvec import fused_chain_matvec
from repro_torch.kernels.kron_matvec._layout import resolve_device

# Reconstruction guard: refuse to materialize more than this many elements
# (the reference's, unchanged: it is the baseline's wall, not a device limit).
OOM_GUARD_ELEMS = 1 << 27  # 128M elems = 1 GiB of float64

_PIDENTITY_CACHE: Dict[tuple, np.ndarray] = {}


def _make_a(theta: torch.Tensor) -> torch.Tensor:
    n = theta.shape[1]
    eye = torch.eye(n, dtype=theta.dtype, device=theta.device)
    A = torch.cat([eye, torch.nn.functional.softplus(theta)])
    return A / torch.sqrt(torch.sum(A * A, dim=0))


def _adam_pidentity(WtW: torch.Tensor, theta0: torch.Tensor, iters: int,
                    lr: float) -> torch.Tensor:
    """``iters`` Adam steps on the p-Identity trace objective from ``theta0``
    (p, n), on ``theta0``'s device and dtype; returns θ."""
    n = theta0.shape[1]
    eye = torch.eye(n, dtype=theta0.dtype, device=theta0.device)

    def loss(theta):
        A = _make_a(theta)
        M = A.T @ A + 1e-9 * eye
        return torch.trace(torch.linalg.solve(M, WtW))

    theta = theta0
    mo = torch.zeros_like(theta)
    ve = torch.zeros_like(theta)
    for i in range(iters):
        th = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(th), th)
        mo = 0.9 * mo + 0.1 * g
        ve = 0.999 * ve + 0.001 * g * g
        mh = mo / (1 - 0.9 ** (i + 1.0))
        vh = ve / (1 - 0.999 ** (i + 1.0))
        theta = theta - lr * mh / (torch.sqrt(vh) + 1e-9)
    return theta.detach()


def opt_pidentity(W: np.ndarray, p: Optional[int] = None, iters: int = 1000,
                  lr: float = 0.05, seed: int = 0, device=None) -> np.ndarray:
    """Optimize a p-Identity strategy for a 1-D workload W; returns A with
    unit-L2 columns (pcost(A x + N(0,I)) = 1), float64 on the host.

    Runs on ``device`` (CUDA unless ``device="cpu"``).  The start point
    θ₀ = 0.5·N(0, 1) − 1 of shape (p, n) is drawn from a CPU
    ``torch.Generator`` seeded with ``seed``, so it is the same on every
    device.  Memoized on (W bytes, p, iters, seed), as in the reference:
    union workloads re-optimize the same per-attribute matrices many times.
    """
    dev = resolve_device(device)
    W = np.asarray(W, dtype=np.float64)
    ck = (W.shape, W.tobytes(), p, iters, seed)
    hit = _PIDENTITY_CACHE.get(ck)
    if hit is not None:
        return hit
    n = W.shape[1]
    if n == 1:
        return np.ones((1, 1))
    p = p if p is not None else max(1, n // 16 + 1)
    gen = torch.Generator().manual_seed(seed)
    theta0 = torch.randn((p, n), generator=gen) * 0.5 - 1.0
    WtW = torch.as_tensor(W.T @ W, dtype=torch.float32, device=dev)
    theta = _adam_pidentity(WtW, theta0.to(dev), iters, lr)
    out = _make_a(theta).cpu().numpy().astype(np.float64)
    _PIDENTITY_CACHE[ck] = out
    return out


def opt_pidentity_projected(W: np.ndarray, **kw) -> np.ndarray:
    """Strategy for W with the all-ones row projected out (paper §9 setup):
    optimize on P₁ = W - W·11ᵀ/n, then return the strategy (used as S_i)."""
    W = np.asarray(W, dtype=np.float64)
    n = W.shape[1]
    P1 = W - (W @ np.ones((n, 1))) @ np.ones((1, n)) / n
    return opt_pidentity(P1, **kw)


@dataclass
class HdmmKron:
    """OPT_⊗: a Kronecker-product strategy ⊗ A_i for a workload ⊗ W_i."""

    factors_W: List[np.ndarray]
    factors_A: List[np.ndarray] = field(default_factory=list)
    tv_unit: float = 0.0          # total variance at pcost budget 1
    maxvar_unit: float = 0.0      # max per-query variance at budget 1

    @staticmethod
    def optimize(factors_W: Sequence[np.ndarray], **kw) -> "HdmmKron":
        """Per-axis strategies; ``kw`` goes to :func:`opt_pidentity`
        (``device`` among them)."""
        A, tvs, mvs = [], [], []
        for Wi in factors_W:
            Wi = np.asarray(Wi, dtype=np.float64)
            if Wi.shape == (1, Wi.shape[1]):          # all-ones (marginalized axis)
                Ai = np.ones((1, Wi.shape[1]))
                Ai = Ai / np.linalg.norm(Ai, axis=0)  # unit cols
            elif Wi.shape[0] == Wi.shape[1] and np.allclose(Wi, np.eye(Wi.shape[1])):
                Ai = np.eye(Wi.shape[1])              # identity is optimal for itself
            else:
                Ai = opt_pidentity(Wi, **kw)
            A.append(Ai)
            M = Ai.T @ Ai
            G = Wi @ np.linalg.pinv(M) @ Wi.T
            tvs.append(float(np.trace(G)))
            mvs.append(float(np.max(np.diag(G))))
        return HdmmKron(list(map(np.asarray, factors_W)), A,
                        float(np.prod(tvs)), float(np.prod(mvs)))

    @property
    def n_queries(self) -> int:
        return int(np.prod([w.shape[0] for w in self.factors_W]))


@dataclass
class HdmmUnion:
    """OPT_+: a union of Kron strategies with optimal budget allocation."""

    subs: List[HdmmKron]
    shares: np.ndarray            # fraction of pcost given to each sub-strategy
    tv_unit: float                # total variance of the whole union at budget 1

    @staticmethod
    def optimize(subs: Sequence[HdmmKron]) -> "HdmmUnion":
        tv = np.array([s.tv_unit for s in subs])
        shares = np.sqrt(tv)
        shares = shares / shares.sum()
        tv_total = float((np.sqrt(tv).sum()) ** 2)  # Σ tv_j / share_j, Σ share = 1
        return HdmmUnion(list(subs), shares, tv_total)

    def total_variance(self, pcost_budget: float = 1.0) -> float:
        return self.tv_unit / pcost_budget

    def rmse(self, pcost_budget: float = 1.0) -> float:
        cells = sum(s.n_queries for s in self.subs)
        return math.sqrt(self.total_variance(pcost_budget) / cells)

    def max_variance(self, pcost_budget: float = 1.0) -> float:
        return max(s.maxvar_unit / (sh * pcost_budget)
                   for s, sh in zip(self.subs, self.shares))


def _marginal_factors_dense(domain: Domain, clique: Clique) -> List[np.ndarray]:
    return [np.eye(a.size) if i in set(clique) else np.ones((1, a.size))
            for i, a in enumerate(domain.attributes)]


def hdmm_marginals(workload: MarginalWorkload, **kw) -> HdmmUnion:
    """HDMM (DefaultUnionKron) on a pure-marginal workload."""
    subs = [HdmmKron.optimize(_marginal_factors_dense(workload.domain, c), **kw)
            for c in workload.cliques]
    return HdmmUnion.optimize(subs)


def hdmm_generalized(workload: MarginalWorkload, kinds: Sequence[str],
                     **kw) -> HdmmUnion:
    """HDMM on generalized marginals (per-attribute basic matrices, §9 setup);
    its p-Identity strategies run on ``kw``'s ``device`` (CUDA unless
    ``device="cpu"``)."""
    from repro_torch.core.plus import build_w
    subs = []
    for c in workload.cliques:
        facs = []
        for i, a in enumerate(workload.domain.attributes):
            facs.append(build_w(kinds[i], a.size) if i in set(c)
                        else np.ones((1, a.size)))
        subs.append(HdmmKron.optimize(facs, **kw))
    return HdmmUnion.optimize(subs)


# ---------------------------------------------------------------------------
# Universe-sized measurement + reconstruction (the part that hits HDMM's wall)
# ---------------------------------------------------------------------------

def hdmm_measure_reconstruct(union: HdmmUnion, domain: Domain, x,
                             gen: Optional[torch.Generator] = None,
                             pcost_budget: float = 1.0,
                             device=None) -> List[torch.Tensor]:
    """y_j = ⊗A_i x + noise;  x̂_j = ⊗ A_i† y_j;  answers = ⊗W_i x̂_j.

    ``x`` is the universe vector (numpy, or a tensor, which stays where it
    is when it already lies on the device as float32).  Runs on ``device``
    (CUDA unless ``device="cpu"``); each sub-strategy draws its noise with
    one ``torch.randn(m, generator=gen)`` in ``union.subs`` order.  Returns
    one flat float32 answer tensor per sub-strategy, on the device.
    Materializes universe-sized intermediates exactly like HDMM's
    reconstruction; raises ``MemoryError`` above :data:`OOM_GUARD_ELEMS`
    universe cells before anything is allocated.
    """
    d = domain.universe_size()
    if d > OOM_GUARD_ELEMS:
        raise MemoryError(f"HDMM reconstruction needs a {d}-element universe vector")
    dev = resolve_device(device)
    return _measure_reconstruct(
        union, domain, x,
        lambda m: torch.randn(m, generator=gen, device=dev), pcost_budget,
        dev)


def _measure_reconstruct(union: HdmmUnion, domain: Domain, x,
                         draw: Callable[[int], torch.Tensor],
                         pcost_budget: float,
                         dev: torch.device) -> List[torch.Tensor]:
    """:func:`hdmm_measure_reconstruct` with the standard normal vectors
    from ``draw(m)``, called once per sub-strategy in order (tests feed the
    reference's draws through it)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)
    if x.numel() != domain.universe_size():
        raise ValueError(f"x has {x.numel()} cells, the universe "
                         f"{domain.universe_size()}")
    answers = []
    for sub, share in zip(union.subs, union.shares):
        budget = share * pcost_budget
        dims = [w.shape[1] for w in sub.factors_W]
        a_rows = [a.shape[0] for a in sub.factors_A]
        y = fused_chain_matvec(sub.factors_A, x, dims)
        y = y + draw(math.prod(a_rows)).to(torch.float32) / math.sqrt(budget)
        pinvs = [np.linalg.pinv(a) for a in sub.factors_A]
        xhat = fused_chain_matvec(pinvs, y, a_rows)
        answers.append(fused_chain_matvec(sub.factors_W, xhat, dims))
        del y, xhat    # one universe-sized x̂ alive at a time, not two
    return answers
