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

On a mesh (DTensor parameters) ``torch.func`` cannot run: it wraps each
DTensor in a plain functorch tensor, which has no ``to_local``, so no
region can open.  There the examples run one at a time through plain
autograd, each as a batch of one, as the reference's ``vmap`` feeds them:

* every ``(pod, data)`` coordinate takes its own rows of the batch, and the
  ranks of its ``model`` axis (the *example mesh*, the mesh without its
  batch axes) run each of them together, the parameters gathered over the
  batch axes.  So an example's tokens meet no other example's, in the
  expert-parallel MoE too: each is routed alone, with its own capacity;
* an example's norm is the norm of its whole gradient: each leaf's local
  sum of squares is added over the mesh axes that split it
  (:func:`~repro_torch.train.optimizer.global_norm`), and the example is
  clipped by it;
* the clipped sums are added over the batch axes and divided by the global
  batch, then placed like their parameters.

:func:`add_dp_noise` draws each leaf's noise at the leaf's global shape, in
the tree's order, and keeps the local shard, so a mesh step adds exactly
the noise a one-device step adds from the same generator state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.accountant import (PrivacyBudget, approx_dp_eps, gdp_mu,
                                         zcdp_rho)

from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.sharding import (all_reduce, batch_axis_names,
                                         batch_rows, current_rules, is_dtensor,
                                         place, sharding_rules, wrap_local)


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
    keep every intermediate alive.  DTensor parameters (a mesh model's)
    take the per-example loop of :func:`_mesh_clipped_grad`."""
    if any(is_dtensor(p) for p in tree_leaves(params)):
        return _mesh_clipped_grad(loss_fn, params, batch, clip_norm)

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


def example_mesh(mesh):
    """The mesh without its batch axes: the ranks that run one example
    together (the whole mesh when the rules split no batch)."""
    batch = batch_axis_names(mesh)
    names = tuple(a for a in mesh.mesh_dim_names if a not in batch)
    if not names:
        raise ValueError(f"a mesh of axes {mesh.mesh_dim_names} has no axis "
                         f"besides the batch axes {batch}")
    return mesh if not batch else mesh[names if len(names) > 1 else names[0]]


def _gathered_placements(p):
    """``p``'s placements with every batch axis replicated."""
    from torch.distributed.tensor import Replicate
    batch = batch_axis_names(p.device_mesh)
    return [Replicate() if n in batch else pl
            for n, pl in zip(p.device_mesh.mesh_dim_names, p.placements)]


def _on_example_mesh(p, sub):
    """Parameter ``p`` gathered over the batch axes, as a leaf DTensor on
    the example mesh ``sub`` (its local shard shared when nothing needs
    gathering)."""
    with torch.no_grad():
        local = p.redistribute(p.device_mesh,
                               _gathered_placements(p)).to_local()
    batch = batch_axis_names(p.device_mesh)
    pl = [pl for n, pl in zip(p.device_mesh.mesh_dim_names, p.placements)
          if n not in batch]
    return wrap_local(local.detach(), sub, pl, p.shape).requires_grad_()


def _mesh_clipped_grad(loss_fn, params, batch, clip_norm: float):
    """:func:`per_example_clipped_grad` for DTensor parameters on one mesh:
    this coordinate's examples one by one on the example mesh, each
    clipped by its global norm; the clipped sum added over the batch axes;
    the mean placed like ``params``."""
    from repro_torch.train.optimizer import global_norm, placed_like
    mesh = tree_leaves(params)[0].device_mesh
    sub = example_mesh(mesh)
    ex_params = tree_map(lambda p: _on_example_mesh(p, sub), params)
    ex_leaves = tree_leaves(ex_params)
    acc_tree = tree_map(lambda p: torch.zeros(
        p.to_local().shape, dtype=torch.float32, device=p.device), ex_params)
    acc = tree_leaves(acc_tree)
    B = next(iter(tree_leaves(batch))).shape[0]
    b0, b1 = batch_rows(mesh, B)
    with sharding_rules(sub, current_rules()):
        for j in range(b0, b1):
            loss = loss_fn(ex_params, tree_map(lambda x: x[j:j + 1], batch))
            grads = torch.autograd.grad(loss, ex_leaves, allow_unused=True)
            with torch.no_grad():
                grads = [torch.zeros_like(p) if g is None else placed_like(g, p)
                         for g, p in zip(grads, ex_leaves)]
                n = global_norm(grads)
                scale = torch.clamp(clip_norm / torch.clamp_min(n, 1e-12),
                                    max=1.0)
                for a, g in zip(acc, grads):
                    a.add_(g.to_local().float() * scale)
            del loss, grads

    def mean(a, p):
        a = all_reduce(a, mesh, batch_axis_names(mesh))
        g = wrap_local((a / B).to(p.dtype), mesh, _gathered_placements(p),
                       p.shape)
        return g.redistribute(mesh, p.placements)

    with torch.no_grad():
        return tree_map(mean, acc_tree, params)


def add_dp_noise(grads, gen: torch.Generator, clip_norm: float,
                 noise_multiplier: float, batch_size: int):
    """``grads`` plus Gaussian noise of std ``C·σ/B`` (the clipped mean's
    sensitivity): one ``torch.randn`` per leaf from ``gen`` (a generator on
    the leaves' device), in the tree's order, at the leaf's global shape.
    A DTensor leaf keeps its shard of the draw, which is freed before the
    next leaf is drawn."""
    std = clip_norm * noise_multiplier / batch_size

    def noisy(g):
        z = std * torch.randn(g.shape, generator=gen, dtype=torch.float32,
                              device=g.device)
        if is_dtensor(g):
            z = place(z, g.device_mesh, g.placements)
        return g + z.to(g.dtype)

    return tree_map(noisy, grads)
