"""Train and eval steps: microbatched gradient accumulation, remat, optional
DP-SGD (per-example clipping + calibrated noise) and the AdamW update; the
port of ``repro.train.train_step``.

A :data:`TrainState` is ``{"params", "opt": {"m", "v", "count"}, "rng"}``.
``params`` is the model's own parameter tree (``Model.tree()``): the model's
parameters are the step's working storage, updated in place, so a state
whose ``params`` are other tensors (a restored checkpoint) is copied into
them first.  ``rng`` is the DP generator's state (``torch.Generator.
get_state()``), so a resumed run draws the noise the uninterrupted one
would.

Microbatch gradients accumulate in the parameters' ``.grad`` through
``backward()`` of ``loss / microbatches``, in the parameters' dtype
(float32 for float32 parameters, bf16 for bf16 ones, as the reference's
accumulator); no second gradient tree is held.

On a mesh (a model built with ``mesh=``) every rank passes the same whole
batch.  Microbatch *i* is the batch's global chunk *i*, as the reference
splits it, and the model keeps this rank's rows of it, so each
microbatch's masked mean is the whole chunk's.  The gradients accumulate
as DTensors and are placed like their parameters before the update.
DP-SGD runs there too: each ``(pod, data)`` coordinate clips its own
examples one at a time on the ``model`` ranks, the clipped sums are added
over the batch axes, and the noise is drawn at each leaf's global shape
(:mod:`repro_torch.train.dp`), so a mesh step equals the one-device step
from the same generator state.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map, tree_paths
from repro_torch.models.transformer import Model

from .dp import DPSGDConfig, add_dp_noise, per_example_clipped_grad
from .optimizer import (AdamWConfig, apply_updates, init_opt_state,
                        placed_like)

TrainState = Dict[str, Any]   # {'params', 'opt': {'m','v','count'}, 'rng'}


def init_train_state(model: Model, opt_cfg: AdamWConfig,
                     seed: int = 0) -> TrainState:
    """The model's parameters, zero moments and the DP generator seeded
    ``seed`` on the model's device (the model holds its seeded weights:
    ``Model.init(cfg, gen)``)."""
    params = model.tree()
    gen = torch.Generator(model.device).manual_seed(seed)
    return {"params": params, "opt": init_opt_state(params, opt_cfg),
            "rng": gen.get_state()}


def functional_loss(model: Model):
    """``loss(params, batch)``: the model's loss without remat
    (``Model.forward``), ``params`` (a tree of the model's structure) in
    place of its own."""
    def loss(params, batch):
        return torch.func.functional_call(model, tree_paths(params, "."),
                                          (batch,))
    return loss


def _bind(model: Model, params):
    """The model's parameter tree, holding ``params``' values."""
    mine = model.tree()
    src, dst = tree_leaves(params), tree_leaves(mine)
    if len(src) != len(dst):
        raise ValueError(f"{len(src)} parameters for a model of {len(dst)}")
    if any(a is not b for a, b in zip(src, dst)):
        with torch.no_grad():
            for a, b in zip(src, dst):
                b.copy_(a)
    return mine


def _split_microbatches(batch, n: int):
    def sp(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} % microbatches {n} != 0")
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    return tree_map(sp, batch)


def _on_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1, dp: Optional[DPSGDConfig] = None,
                    remat: bool = True):
    """Build ``train_step(state, batch) -> (state, metrics)``; metrics are
    ``loss`` (the mean of the microbatch losses), ``grad_norm`` and ``lr``
    as 0-d tensors.  Switches the model's gradients on.  The DP path takes
    its per-example gradients without remat (:mod:`repro_torch.train.dp`);
    on a mesh model it clips the examples one at a time."""
    model.requires_grad_(True)
    dp_loss = functional_loss(model)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        params = _bind(model, state["params"])
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        batch = _on_device(batch, model.device)
        mbs = _split_microbatches(batch, microbatches)
        loss = torch.zeros((), device=model.device)
        for i in range(microbatches):
            mb = {k: v[i] for k, v in mbs.items()}
            if dp is not None:
                g = per_example_clipped_grad(dp_loss, params, mb, dp.clip_norm)
                with torch.no_grad():
                    for p, gi in zip(leaves, tree_leaves(g)):
                        gi = gi.to(p.dtype) / microbatches
                        p.grad = gi if p.grad is None else p.grad.add_(gi)
                    l = model.loss_fn(mb, remat=False)
            else:
                l = model.loss_fn(mb, remat=remat)
                (l / microbatches).backward()
            loss = loss + l.detach() / microbatches
        for p in leaves:
            p.grad = placed_like(p.grad, p)
        grads = tree_map(lambda p: p.grad, params)
        rng = state["rng"]
        if dp is not None:
            gen = torch.Generator(model.device)
            gen.set_state(rng.cpu())
            bsz = next(iter(batch.values())).shape[0]
            grads = add_dp_noise(grads, gen, dp.clip_norm, dp.noise_multiplier,
                                 bsz)
            rng = gen.get_state()
        _, new_opt, om = apply_updates(params, grads, state["opt"], opt_cfg)
        del grads
        for p in leaves:
            p.grad = None
        return {"params": params, "opt": new_opt, "rng": rng}, {"loss": loss, **om}

    return train_step


def make_eval_step(model: Model):
    """``eval_step(params, batch)``: the loss without remat or gradients,
    ``params`` a tree of the model's structure (its own or another)."""
    loss = functional_loss(model)

    def eval_step(params, batch):
        with torch.no_grad():
            return loss(params, _on_device(batch, model.device))

    return eval_step
