"""AdamW with optional int8 block-quantized moments: the port of
``repro.train.optimizer``.

Quantization keeps the parameter's shape: an int8 tensor of the same shape
plus one float32 scale per 128-wide block of the last axis (one block when
the last axis is not a multiple of 128), as in the reference.

:func:`apply_updates` follows the reference's update in its order (warmup
learning rate, global-norm clip, bias-corrected moments, ``m̂/(√v̂+ε) +
wd·p``), but writes the parameters and moments in place, one leaf at a
time (a large leaf in slices of rows, :data:`CHUNK`): a temporary over
the whole tree would hold another copy of every parameter.
``torch.optim.AdamW`` is not used: it has no int8 moments and applies the
decay in another order.

On a mesh (DTensor parameters) the moments are placed as the reference's
``_opt_axes_like`` places them: a float32 moment and an int8 ``q`` like
their parameter, the scale ``s`` like it but for its last axis, which is
whole on every rank.  The update runs on each rank's local shards.  The
int8 blocks are the global 128-wide blocks of the last axis, as GSPMD
computes them on the full array: where a shard boundary splits a block, or
the last axis is one block that spans every shard, the block's max is
taken across the ranks that hold it, so each shard's ``q`` and ``s`` equal
the full tensor's :func:`quantize_i8` bit for bit.  :func:`global_norm`
counts each element once: every leaf's local sum of squares is added over
the mesh axes that split it and no others.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.sharding import chunk_bounds, is_dtensor, wrap_local

BLOCK = 128
MOMENT_DTYPE = torch.float32     # the float moments' dtype, as the reference's


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


def _blocks(last: int) -> Tuple[int, int]:
    """(blocks, block width) of a last axis of ``last`` entries."""
    if last % BLOCK == 0 and last >= BLOCK:
        return last // BLOCK, BLOCK
    return 1, last


def _block_view(x: torch.Tensor):
    nb, b = _blocks(x.shape[-1])
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


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its own storage, under ``no_grad``), or
    ``t``."""
    return t.to_local() if is_dtensor(t) else t


def placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` placed as its parameter ``p`` (a partial sum
    reduced, a replicated value sliced)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _split_dims(x: torch.Tensor, dim: Optional[int] = None) -> Tuple[int, ...]:
    """The mesh dims that split DTensor ``x`` (along tensor dim ``dim``
    only, when given); none for a plain tensor."""
    if not is_dtensor(x):
        return ()
    from torch.distributed.tensor import Shard
    return tuple(i for i, pl in enumerate(x.placements)
                 if isinstance(pl, Shard) and (dim is None or pl.dim == dim))


def _last_axis(p: torch.Tensor):
    """(this shard's first column, the global last axis, the mesh dims that
    split it) of parameter ``p``: where its int8 blocks lie."""
    off, n = 0, p.shape[-1]
    dims = _split_dims(p, p.dim() - 1)
    for i in dims:
        mesh = p.device_mesh
        lo, hi = chunk_bounds(n, mesh.size(i), mesh.get_local_rank(i))
        off, n = off + lo, hi - lo
    return off, p.shape[-1], dims


def _zeros_moment(p: torch.Tensor, cfg: AdamWConfig):
    z = torch.zeros_like(p, dtype=torch.int8 if cfg.int8_states
                         else MOMENT_DTYPE)
    if not cfg.int8_states:
        return z
    nb, _ = _blocks(p.shape[-1])
    s = torch.zeros(_local(p).shape[:-1] + (nb,), dtype=torch.float32,
                    device=_local(p).device)
    if is_dtensor(p):
        from torch.distributed.tensor import Replicate, Shard
        last = p.dim() - 1
        pl = [Replicate() if isinstance(x, Shard) and x.dim == last else x
              for x in p.placements]
        s = wrap_local(s, p.device_mesh, pl, p.shape[:-1] + (nb,))
    return {"q": z, "s": s}


def init_opt_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments on each parameter's device (float32, or int8 ``q`` and
    float32 ``s``), placed on a mesh as described above, and ``count`` a 0-d
    int32 tensor on the host."""
    return {"m": tree_map(lambda p: _zeros_moment(p, cfg), params),
            "v": tree_map(lambda p: _zeros_moment(p, cfg), params),
            "count": torch.zeros((), dtype=torch.int32)}


def _block_index(off: int, cols: int, last: int, device) -> torch.Tensor:
    """The global block of each of ``cols`` columns from column ``off``."""
    _, b = _blocks(last)
    return torch.arange(off, off + cols, device=device) // b


def quantize_shard(x: torch.Tensor, p: torch.Tensor):
    """:func:`quantize_i8` of the float32 local shard ``x`` of a moment of
    parameter ``p``: this shard's ``q`` and the scales of its rows' every
    block, the blocks those of the global last axis (a block split over
    ranks takes its max across them)."""
    off, last, dims = _last_axis(p)
    if not dims:
        return quantize_i8(x)
    nb, _ = _blocks(last)
    blk = _block_index(off, x.shape[-1], last, x.device)
    amax = x.new_zeros(x.shape[:-1] + (nb,))
    amax.scatter_reduce_(-1, blk.expand(x.shape), x.abs(), "amax")
    for i in dims:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                        group=p.device_mesh.get_group(i))
    scale = amax / 127.0
    q = torch.round(x / scale.clamp_min(1e-30)[..., blk]).to(torch.int8)
    return q, scale


def dequantize_shard(q: torch.Tensor, scale: torch.Tensor,
                     p: torch.Tensor) -> torch.Tensor:
    """:func:`dequantize_i8` of a local shard (``scale`` its rows' every
    block), as :func:`quantize_shard` lays it out."""
    off, last, dims = _last_axis(p)
    if not dims:
        return dequantize_i8(q, scale)
    return q.float() * scale[..., _block_index(off, q.shape[-1], last, q.device)]


def _load(moment, p, rows, cfg: AdamWConfig) -> torch.Tensor:
    """Local ``rows`` of the moment of parameter ``p`` as a float32 tensor:
    the state's own storage (updated in place) or a dequantized copy."""
    if cfg.int8_states:
        return dequantize_shard(_local(moment["q"])[rows],
                                _local(moment["s"])[rows], p)
    return _local(moment)[rows]


def _store(moment, p, rows, x: torch.Tensor, cfg: AdamWConfig) -> None:
    if cfg.int8_states:
        q, s = quantize_shard(x, p)
        _local(moment["q"])[rows].copy_(q)
        _local(moment["s"])[rows].copy_(s)


CHUNK = 1 << 26      # elements of a leaf updated at once


def _row_slices(p: torch.Tensor):
    """Slices of the first axis of ``p``'s local shard, each at most
    :data:`CHUNK` elements of float32 temporaries (whole rows, so the int8
    blocks of the last axis stay whole; counted from the global row size,
    so the ranks that split a row's blocks take the same slices)."""
    n = _local(p).shape[0] if p.dim() > 1 else 0
    step = max(1, CHUNK // max(math.prod(p.shape[1:]), 1))
    return [slice(i, i + step) for i in range(0, n, step)] or [slice(None)]


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over every leaf, in float32 (a 0-d tensor on the leaves'
    device, alike on every rank).  A DTensor leaf's local sum of squares
    is added over the mesh dims that split it; leaves split alike are
    reduced together."""
    groups: Dict[Tuple[int, ...], Any] = {}
    meshes = {}
    for x in tree_leaves(tree):
        dims = _split_dims(x)
        s = torch.sum(torch.square(_local(x).float()))
        groups[dims] = s if dims not in groups else groups[dims] + s
        if dims:
            meshes[dims] = x.device_mesh
    total = None
    for dims in sorted(groups):
        s = groups[dims].reshape(1)
        for i in dims:
            dist.all_reduce(s, group=meshes[dims].get_group(i))
        total = s if total is None else total + s
    return torch.sqrt(total).reshape(())


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
    flat_p = tree_leaves(params)
    flat_g = [placed_like(g, p)
              for g, p in zip(tree_leaves(grads), flat_p, strict=True)]
    gnorm = global_norm(flat_g)
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                       / torch.clamp_min(gnorm, 1e-12), max=1.0)
    flat_m = _at_leaves_of(state["m"], params)
    flat_v = _at_leaves_of(state["v"], params)
    for p_, g_, m_, v_ in zip(flat_p, flat_g, flat_m, flat_v, strict=True):
        for rows in _row_slices(p_):
            p = _local(p_)[rows]
            g = _local(g_)[rows].float() * clip
            m = _load(m_, p_, rows, cfg)
            v = _load(v_, p_, rows, cfg)
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            t = g * (1 - cfg.b2)
            v.mul_(cfg.b2).add_(t.mul_(g))
            _store(m_, p_, rows, m, cfg)
            _store(v_, p_, rows, v, cfg)
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
