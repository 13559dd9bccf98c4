"""DP-SGD priced by the paper's accountant: the port of ``repro.train.dp``.

Per-example clipped gradients plus Gaussian noise form a linear Gaussian
mechanism in the sense of Definition 2: sensitivity C, noise N(0, (Cσ)² I),
so each step has pcost = 1/σ², and steps compose additively (end of §2.1).
The accountant is :mod:`repro_torch.core.accountant`, the code that prices
the marginal mechanisms, so one budget can pay for noisy-marginal releases
and for DP training.

Per-example gradients come from ``torch.func.vmap(torch.func.grad(...))``
over ``torch.func.functional_call``.  ``torch.func.grad`` refuses the saved
tensor hooks that ``torch.utils.checkpoint`` works through, so the DP path
runs its loss without remat; remat changes memory, not values
(``tests/test_torch_dp.py`` holds a one-example DP gradient equal to the
remat path's).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.accountant import (PrivacyBudget, approx_dp_eps, gdp_mu,
                                         zcdp_rho)

from repro_torch.models.layers import tree_leaves, tree_map


@dataclass(frozen=True)
class DPSGDConfig:
    clip_norm: float = 1.0
    noise_multiplier: float = 1.0      # σ: noise stddev = C·σ

    @property
    def pcost_per_step(self) -> float:
        return 1.0 / (self.noise_multiplier ** 2)


class DPSGDAccountant:
    """Sequential-composition accounting for a DP-SGD run."""

    def __init__(self, cfg: DPSGDConfig, budget: Optional[PrivacyBudget] = None):
        self.cfg = cfg
        self.budget = budget
        self.steps = 0

    def charge_step(self):
        """Count one step once the budget has paid for it (the reference
        counts first, so a refused step stays in its report)."""
        if self.budget is not None:
            self.budget.charge(self.cfg.pcost_per_step)
        self.steps += 1

    @property
    def pcost(self) -> float:
        return self.steps * self.cfg.pcost_per_step

    def report(self) -> dict:
        pc = self.pcost
        return {"steps": self.steps, "pcost": pc, "rho_zcdp": zcdp_rho(pc),
                "mu_gdp": gdp_mu(pc),
                "eps_at_delta_1e-6": approx_dp_eps(pc, 1e-6)}


def per_example_clipped_grad(loss_fn, params, batch, clip_norm: float):
    """Mean of per-example gradients, each clipped to L2 <= ``clip_norm``.

    ``loss_fn(params, batch)`` is a scalar loss of a parameter tree (nested
    dicts/lists of tensors) and a batch (a dict of tensors led by the batch
    axis); each example is fed as a batch of one.  Returns a tree of
    ``params``' structure.  The parameters enter detached: with their
    ``requires_grad`` on (a training model's), autograd would otherwise
    record the whole per-example computation for a second derivative and
    keep every intermediate alive."""
    def single(p, example):
        return loss_fn(p, tree_map(lambda x: x[None], example))

    grads = torch.func.vmap(torch.func.grad(single), in_dims=(None, 0))(
        tree_map(torch.Tensor.detach, params), batch)   # leaves: (B, *shape)
    sq = None
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.reshape(g.shape[0], -1).float()), dim=1)
        sq = s if sq is None else sq + s
    n = torch.sqrt(sq)
    scale = torch.clamp(torch.full_like(n, clip_norm) / torch.clamp_min(n, 1e-12),
                        max=1.0)
    return tree_map(lambda g: torch.mean(
        g * scale.reshape((-1,) + (1,) * (g.dim() - 1)), dim=0), grads)


def add_dp_noise(grads, gen: torch.Generator, clip_norm: float,
                 noise_multiplier: float, batch_size: int):
    """``grads`` plus Gaussian noise of std ``C·σ/B`` (the clipped mean's
    sensitivity): one ``torch.randn`` per leaf from ``gen`` (a generator on
    the leaves' device), in the tree's order."""
    std = clip_norm * noise_multiplier / batch_size
    return tree_map(lambda g: g + (std * torch.randn(
        g.shape, generator=gen, dtype=torch.float32, device=g.device)).to(g.dtype),
        grads)
