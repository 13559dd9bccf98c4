"""Mixture-of-Experts FFN: the port of ``repro.models.moe``, with expert
parallelism under a mesh.

Routing is softmax → top-k → renormalise, with the Switch load-balancing
auxiliary loss.  Without a mesh (or on one whose ``model`` axis is 1) the
dense fallback computes every expert on every token and gates the outputs.

On a mesh whose ``model`` axis is larger than 1, :func:`moe_apply` runs a
``local_map`` region (the reference's ``shard_map``) over each rank's
tokens and its experts (``experts`` over ``model``, each expert's d_ff
slice over ``data``), never the dense path:

* prefill (the sequence divides by the ``model`` size): this rank's chunk
  of the sequence is dispatched capacity-bounded (GShard-style drops, sort-
  free bucket slots) with ``all_to_all_single`` over ``model`` to the
  experts' ranks and back, with the reference's capacities ``cap1`` and
  ``cap2`` and drop rule;
* decode (S = 1 cannot be split): every ``model`` rank routes all tokens,
  runs its own experts (capacity ``cap``) and the outputs are added over
  ``model``.

One behaviour differs from the reference on purpose.  The reference shards
the tokens over ``data`` *and* each expert's d_ff over ``data``, then adds
its outputs over ``data`` (``src/repro/models/moe.py:155,195``), which adds
other rows' partial sums into each row whenever ``data`` > 1.  Here the
tokens are gathered over ``data`` before the dispatch and the outputs
reduce-scattered back after it, so each token's d_ff slices are summed for
that token.  The capacities count the gathered tokens; at ``data`` = 1 they
are the reference's.  The auxiliary loss keeps the reference's definition:
the mean over ranks of each rank's Switch loss on its own tokens.

``moe_stats()`` counts the region's calls by body (``ep_dispatch``,
``ep_replicated``, ``dense``) and the (token, expert) pairs this rank
dropped for capacity, kept on the device until read.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .config import torch_dtype
from .layers import PDef
from .sharding import (ACT, all_gather_dim, all_reduce, all_to_all, axis_rank,
                       axis_size, batch_axis_names, chunk_bounds, copy_in,
                       current_mesh, gather_scatter_dim, is_dtensor,
                       reduce_scatter_dim, region)

_STATS: Dict[str, Any] = {"ep_dispatch": 0, "ep_replicated": 0, "dense": 0,
                          "dropped": 0}


def moe_stats() -> Dict[str, int]:
    """Region calls by body, and the pairs this rank counted as dropped for
    capacity (read from the device here, not on the path); summed over the
    mesh, each dropped pair counts once."""
    return {k: int(v) for k, v in _STATS.items()}


def reset_moe_stats():
    for k in _STATS:
        _STATS[k] = 0


def _count_dropped(n, mesh):
    """Count ``n`` dropped pairs.  The ranks of one ``model`` index route
    the same tokens (gathered over ``data``) and drop the same pairs, so
    only ``data`` index 0 counts them."""
    if axis_rank(mesh, "data") == 0:
        _STATS["dropped"] = _STATS["dropped"] + n


def moe_defs(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    mo = cfg.moe
    defs = {
        "router": PDef((d, mo.n_experts), (None, None)),
        "w_g": PDef((mo.n_experts, d, mo.d_expert), ("experts", None, "expert_dff")),
        "w_u": PDef((mo.n_experts, d, mo.d_expert), ("experts", None, "expert_dff")),
        "w_o": PDef((mo.n_experts, mo.d_expert, d), ("experts", "expert_dff", None)),
    }
    if mo.n_shared:
        f_sh = mo.n_shared * mo.d_expert
        defs["sh_g"] = PDef((d, f_sh), (None, "expert_dff"))
        defs["sh_u"] = PDef((d, f_sh), (None, "expert_dff"))
        defs["sh_o"] = PDef((f_sh, d), ("expert_dff", None))
    return defs


def bucket_slots(ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """slot[i] = rank of element i within its bucket (stable)."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    first = torch.searchsorted(sorted_ids,
                               torch.arange(n_buckets, device=ids.device,
                                            dtype=ids.dtype), side="left")
    pos = torch.arange(n, device=ids.device) - first[sorted_ids]
    return torch.zeros(n, dtype=torch.int32, device=ids.device).index_put_(
        (order,), pos.to(torch.int32))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis, largest first, ties to the
    lower index (the order of ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_probs(x_flat, router_w, mo):
    """(renormalised top-k weights, top-k experts, router probabilities)."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, mo.top_k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_w, top_e, probs


def _switch_aux(probs, top_e, E: int, mesh=None):
    """Switch-style load-balancing aux loss over the given tokens; with
    ``mesh``, over the tokens of every batch shard (each holding as many):
    the expert densities and mean probabilities averaged over the batch
    axes before their product."""
    density = (top_e[..., :1] == torch.arange(E, device=top_e.device)) \
        .float().mean(dim=0)
    mean_p = probs.mean(dim=0)
    if mesh is not None:
        nb = 1
        for a in batch_axis_names(mesh):
            density = all_reduce(density, mesh, a)
            mean_p = all_reduce(mean_p, mesh, a)
            nb *= axis_size(mesh, a)
        density, mean_p = density / nb, mean_p / nb
    return E * torch.sum(density * mean_p)


def _route(x_flat, router_w, mo, mesh=None):
    top_w, top_e, probs = _route_probs(x_flat, router_w, mo)
    return top_w, top_e, _switch_aux(probs, top_e, mo.n_experts, mesh)


def _moe_dense_fallback(p, x, cfg, mesh=None):
    """Every expert on every token, gated by the routing weights; on a
    mesh (this rank's batch rows) the auxiliary loss is the whole batch's."""
    B, S, d = x.shape
    mo = cfg.moe
    cdt = torch_dtype(cfg.compute_dtype)
    xf = x.reshape(-1, d).to(cdt)
    top_w, top_e, aux = _route(xf, p["router"], mo, mesh)
    h = F.silu(torch.einsum("td,edf->tef", xf, p["w_g"].to(cdt)))
    u = torch.einsum("td,edf->tef", xf, p["w_u"].to(cdt))
    outs = torch.einsum("tef,efd->ted", h * u, p["w_o"].to(cdt))
    gates = torch.zeros((xf.shape[0], mo.n_experts), dtype=cdt,
                        device=x.device).scatter(1, top_e, top_w.to(cdt))
    y = torch.einsum("te,ted->td", gates, outs)
    if mo.n_shared:
        y = y + (F.silu(xf @ p["sh_g"].to(cdt))
                 * (xf @ p["sh_u"].to(cdt))) @ p["sh_o"].to(cdt)
    return y.reshape(B, S, d).to(x.dtype), aux


def _expert_ffn(buf, w_g, w_u, w_o, cdt):
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w_g.to(cdt)))
    u = torch.einsum("ecd,edf->ecf", buf, w_u.to(cdt))
    return torch.einsum("ecf,efd->ecd", h * u, w_o.to(cdt))


def _shared(p, xf, cdt):
    return (F.silu(xf @ p["sh_g"].to(cdt))
            * (xf @ p["sh_u"].to(cdt))) @ p["sh_o"].to(cdt)


def _scatter_rows(idx, rows, n: int, fill=0):
    """An (n, ...) buffer holding ``rows`` at ``idx`` and ``fill``
    elsewhere; an index of n (the overflow slot) drops its row, as the
    reference's ``mode="drop"``."""
    buf = rows.new_full((n + 1,) + rows.shape[1:], fill)
    buf[idx] = rows
    return buf[:n]


def _combine(gathered, keep, top_w, t: int, k: int, cdt):
    """y[token] = Σ over its k kept pairs of weight · expert output; a
    token's pairs are k consecutive rows."""
    g = gathered * keep[:, None].to(gathered.dtype)
    return (g * top_w.reshape(-1)[:, None].to(cdt)).reshape(t, k, -1).sum(1)


def _ep_dispatch(p, xf, top_w, top_e, *, mo, cdt, mesh):
    """Prefill EP body (the reference's ``_moe_local``): this rank's tokens
    sent to their experts' ranks by ``all_to_all`` over ``model``, run
    there capacity-bounded, and sent back.  Returns the routed output."""
    n = axis_size(mesh, "model")
    t, d = xf.shape
    k = mo.top_k
    e_loc = mo.n_experts // n
    flat_e = top_e.reshape(-1)
    src = torch.arange(t, device=xf.device).repeat_interleave(k)
    dest = flat_e // e_loc
    local_e = (flat_e % e_loc).to(torch.int32)

    cap1 = int(math.ceil(t * k / n * mo.capacity_factor))
    slot1 = bucket_slots(dest, n)
    keep1 = slot1 < cap1
    send_idx = torch.where(keep1, dest * cap1 + slot1, n * cap1)
    send = _scatter_rows(send_idx, xf[src], n * cap1)
    send_e = _scatter_rows(send_idx, local_e, n * cap1, fill=-1)  # -1: empty
    recv = all_to_all(send, mesh, "model")
    recv_e = all_to_all(send_e, mesh, "model")
    valid = recv_e >= 0

    cap2 = int(math.ceil(n * cap1 / e_loc * mo.capacity_factor))
    eid = torch.where(valid, recv_e, e_loc).long()
    slot2 = bucket_slots(eid, e_loc + 1)
    keep2 = (slot2 < cap2) & valid
    buf_idx = torch.where(keep2, eid * cap2 + slot2, e_loc * cap2)
    buf = _scatter_rows(buf_idx, recv, e_loc * cap2).reshape(e_loc, cap2, d)
    out = _expert_ffn(buf, p["w_g"], p["w_u"], p["w_o"], cdt)  # partial over f
    back = out.reshape(-1, d)[buf_idx.clamp_max(e_loc * cap2 - 1)]
    back = back * keep2[:, None].to(back.dtype)
    ret = all_to_all(back, mesh, "model")
    gathered = ret[send_idx.clamp_max(n * cap1 - 1)]
    _count_dropped((~keep1).sum() + (valid & ~keep2).sum(), mesh)
    return _combine(gathered, keep1, top_w, t, k, cdt)


def _ep_replicated(p, xf, top_w, top_e, *, mo, cdt, mesh):
    """Decode EP body (the reference's ``_moe_replicated_local``): every
    ``model`` rank holds all tokens, runs only its own experts, and the
    outputs are added over ``model``.  The rest of the region is computed
    alike on every ``model`` rank, so the tokens and weights enter the
    experts through :func:`copy_in`: their gradients, partial over
    ``model`` in here, leave it whole."""
    xf, top_w = copy_in(xf, mesh, "model"), copy_in(top_w, mesh, "model")
    n = axis_size(mesh, "model")
    t, d = xf.shape
    k = mo.top_k
    e_loc = mo.n_experts // n
    flat_e = top_e.reshape(-1)
    src = torch.arange(t, device=xf.device).repeat_interleave(k)
    mine = (flat_e // e_loc) == axis_rank(mesh, "model")
    local_e = torch.where(mine, flat_e % e_loc, e_loc)     # foreign → overflow
    cap = int(math.ceil(t * k / e_loc * mo.capacity_factor))
    slot = bucket_slots(local_e, e_loc + 1)
    keep = (slot < cap) & mine
    idx = torch.where(keep, local_e * cap + slot, e_loc * cap)
    buf = _scatter_rows(idx, xf[src], e_loc * cap).reshape(e_loc, cap, d)
    out = _expert_ffn(buf, p["w_g"], p["w_u"], p["w_o"], cdt)
    gathered = out.reshape(-1, d)[idx.clamp_max(e_loc * cap - 1)]
    _count_dropped((mine & ~keep).sum(), mesh)
    return all_reduce(_combine(gathered, keep, top_w, t, k, cdt), mesh, "model")


def _moe_ep_local(x, p, *, cfg, mesh):
    """The region body on local shards: x (b_loc, S, d) this rank's batch
    rows (all of the sequence), the router whole, this rank's experts and
    their d_ff slice.  Returns (y (b_loc, S, d), aux).

    In training: the gather over ``data`` is reduce-scattered back (each
    data rank runs its d_ff slice on every gathered token), the
    reduce-scatter of the outputs all-gathered, the all_to_alls reversed;
    the sequence slice over ``model`` and its all-gather follow the
    replicated consumer (the gradient of this rank's rows is its chunk)."""
    mo = cfg.moe
    cdt = torch_dtype(cfg.compute_dtype)
    n = axis_size(mesh, "model")
    b_loc, S, d = x.shape
    seq_shardable = S % n == 0
    if seq_shardable:
        lo, hi = chunk_bounds(S, n, axis_rank(mesh, "model"))
        x = x[:, lo:hi]
    s_loc = x.shape[1]
    xs = gather_scatter_dim(x, 0, mesh, "data")
    xf = xs.reshape(-1, d).to(cdt)
    top_w, top_e, probs = _route_probs(xf, p["router"], mo)
    own = slice(axis_rank(mesh, "data") * b_loc * s_loc,
                (axis_rank(mesh, "data") + 1) * b_loc * s_loc)
    aux = _switch_aux(probs[own], top_e[own], mo.n_experts)
    body = _ep_dispatch if seq_shardable else _ep_replicated
    _STATS["ep_dispatch" if seq_shardable else "ep_replicated"] += 1
    y = body(p, xf, top_w, top_e, mo=mo, cdt=cdt, mesh=mesh)
    if mo.n_shared:
        y = y + _shared(p, xf, cdt)
    # d_ff slices over 'data': each gathered token's partial sums added for
    # that token, then this rank's rows kept.
    y = reduce_scatter_dim(y.reshape(-1, s_loc, d), 0, mesh, "data")
    if seq_shardable:
        y = all_gather_dim(y.contiguous(), 1, mesh, "model", S)
    # the mean over the mesh of each shard's own aux; the model ranks of the
    # replicated body route the same tokens, so it averages over the rest
    aux, count = aux.reshape(1), 1
    for axis in mesh.mesh_dim_names:
        if seq_shardable or axis != "model":
            aux = all_reduce(aux, mesh, axis)
            count *= axis_size(mesh, axis)
    return y.to(x.dtype), (aux / count).reshape(())


def moe_apply(p, x, *, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y, aux_loss).  On DTensors: the expert-parallel
    region when the mesh's ``model`` axis is larger than 1 (the dense
    fallback over gathered weights otherwise, as the reference)."""
    if not is_dtensor(x):
        _STATS["dense"] += 1
        return _moe_dense_fallback(p, x, cfg)
    mesh = current_mesh()
    keys = sorted(p)
    n = axis_size(mesh, "model")
    if n == 1:
        def body(x, *leaves):
            _STATS["dense"] += 1
            return _moe_dense_fallback(dict(zip(keys, leaves)), x, cfg, mesh)
        names = [(None,) * p[k].dim() for k in keys]
    else:
        if cfg.moe.n_experts % axis_size(mesh, "model"):
            raise ValueError(f"{cfg.moe.n_experts} experts do not split over "
                             f"a model axis of {axis_size(mesh, 'model')}")

        def body(x, *leaves):
            return _moe_ep_local(x, dict(zip(keys, leaves)), cfg=cfg, mesh=mesh)
        defs = moe_defs(cfg)
        names = [defs[k].axes for k in keys]
    # the model ranks split the sequence (EP dispatch) or route alike
    # (replicated body, S not a multiple of the model axis)
    return region(body, (x,) + tuple(p[k] for k in keys),
                  [("batch", None, None)] + names, (ACT, ()),
                  split_model=x.shape[1] % n == 0)
