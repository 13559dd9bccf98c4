r"""HDMM's 1-D p-Identity strategy optimizer (McKenna et al. [40, 41]) in torch.

The port's copy of ``opt_pidentity`` and ``opt_pidentity_projected`` from
``repro.baselines.hdmm``: A(θ) = [I; B(θ)] with nonnegative B, columns
normalized to unit L2 (so pcost(A) = 1), Adam on ``tr((AᵀA + 1e-9 I)⁻¹ WᵀW)``.
ResidualPlanner+ uses it to produce strategy replacements S_i ("the
1-dimensional optimizer included with HDMM", paper §9).  The Adam loop is the
reference's ``lax.scan`` step by step, in float32, with autograd and
``torch.linalg.solve`` on the resolved device.  The reference's ``HdmmKron``,
``HdmmUnion`` and universe-sized reconstruction are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.kron_matvec._layout import resolve_device

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
