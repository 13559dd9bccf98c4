"""AdamW with optional int8 block-quantized moments: the port of
``repro.train.optimizer``.

Quantization keeps the parameter's shape: an int8 tensor of the same shape
plus one float32 scale per 128-wide block of the last axis (one block when
the last axis is not a multiple of 128), as in the reference.

:func:`apply_updates` follows the reference's update in its order (warmup
learning rate, global-norm clip, bias-corrected moments, ``m̂/(√v̂+ε) +
wd·p``), but writes the parameters and moments in place, one leaf at a
time: a temporary over the whole tree would hold another copy of every
parameter.  ``torch.optim.AdamW`` is not used: it has no int8 moments and
applies the decay in another order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves, tree_map

BLOCK = 128


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    int8_states: bool = False
    warmup_steps: int = 100


def _block_view(x: torch.Tensor):
    last = x.shape[-1]
    if last % BLOCK == 0 and last >= BLOCK:
        nb, b = last // BLOCK, BLOCK
    else:
        nb, b = 1, last
    return x.reshape(x.shape[:-1] + (nb, b)), nb, b


def quantize_i8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 tensor of ``x``'s shape, float32 scale per block)."""
    xb, _, _ = _block_view(x.float())
    scale = xb.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xb / scale.clamp_min(1e-30)).to(torch.int8)
    return q.reshape(x.shape), scale[..., 0]


def dequantize_i8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    qb, _, _ = _block_view(q.float())
    return (qb * scale[..., None]).reshape(q.shape)


def _at_leaves_of(tree, like):
    """The entries of ``tree`` where ``like`` has its leaves: tensors, or an
    int8 moment's ``{"q", "s"}`` dict as one entry."""
    if isinstance(like, dict):
        return [e for k in sorted(like) for e in _at_leaves_of(tree[k], like[k])]
    if isinstance(like, list):
        return [e for t, v in zip(tree, like, strict=True)
                for e in _at_leaves_of(t, v)]
    return [tree]


def _zeros_moment(p: torch.Tensor, cfg: AdamWConfig):
    if cfg.int8_states:
        _, nb, _ = _block_view(p)
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "s": torch.zeros(p.shape[:-1] + (nb,), dtype=torch.float32,
                                 device=p.device)}
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_opt_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments on each parameter's device (float32, or int8 ``q`` and
    float32 ``s``), and ``count`` a 0-d int32 tensor on the host."""
    return {"m": tree_map(lambda p: _zeros_moment(p, cfg), params),
            "v": tree_map(lambda p: _zeros_moment(p, cfg), params),
            "count": torch.zeros((), dtype=torch.int32)}


def _load(moment, cfg: AdamWConfig) -> torch.Tensor:
    """The moment as a float32 tensor: the state's own tensor (updated in
    place) or a dequantized copy."""
    return dequantize_i8(moment["q"], moment["s"]) if cfg.int8_states else moment


def _store(moment, x: torch.Tensor, cfg: AdamWConfig) -> None:
    if cfg.int8_states:
        q, s = quantize_i8(x)
        moment["q"].copy_(q)
        moment["s"].copy_(s)


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over every leaf, in float32 (a 0-d tensor on the leaves'
    device)."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step.  ``params``, ``grads`` and the moments are trees of
    one structure; the parameters and moments are updated in place and
    returned with the state's new ``count`` and the step's metrics
    ``{"grad_norm", "lr"}`` (0-d tensors; ``grads`` is left as it is).

    The arithmetic is the reference's, one rounding per operation, in
    float32: ``lr`` and the bias corrections on the host, the clip factor on
    the device (no host sync)."""
    count = state["count"] + 1
    cf = np.float32(int(count))
    lr = np.float32(cfg.lr) * min(np.float32(1.0),
                                  cf / np.float32(max(cfg.warmup_steps, 1)))
    bc1 = np.float32(1.0) - np.float32(cfg.b1) ** cf
    bc2 = np.float32(1.0) - np.float32(cfg.b2) ** cf
    gnorm = global_norm(grads)
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                       / torch.clamp_min(gnorm, 1e-12), max=1.0)
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    flat_m = _at_leaves_of(state["m"], params)
    flat_v = _at_leaves_of(state["v"], params)
    for p, g, m_, v_ in zip(flat_p, flat_g, flat_m, flat_v, strict=True):
        g = g.float() * clip
        m = _load(m_, cfg)
        v = _load(v_, cfg)
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        t = g * (1 - cfg.b2)
        v.mul_(cfg.b2).add_(t.mul_(g))
        _store(m_, m, cfg)
        _store(v_, v, cfg)
        # upd = m̂ / (√v̂ + ε) + wd·p, in the two temporaries' buffers
        den = torch.div(v, float(bc2), out=g).sqrt_().add_(cfg.eps)
        upd = torch.div(m, float(bc1), out=t).div_(den)
        del den, g
        p32 = p.float()
        upd.add_(p32 * cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(upd.mul_(float(lr)))
        else:
            p.copy_((p32 - upd.mul_(float(lr))).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        {"grad_norm": gnorm, "lr": torch.tensor(float(lr))}
