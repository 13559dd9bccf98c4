"""Mixture-of-Experts FFN on one device: the port of ``repro.models.moe``'s
no-mesh path.

Routing is softmax → top-k → renormalise, with the Switch load-balancing
auxiliary loss; the dense fallback computes every expert on every token
and gates the outputs.  :func:`bucket_slots` is the capacity-bounded
dispatch's slot rank.  The reference's expert-parallel paths (``shard_map``
with ``all_to_all``) need a multi-device ``torch.distributed`` design and
are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .config import torch_dtype
from .layers import PDef


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


def _route(x_flat, router_w, mo):
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, mo.top_k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balancing aux loss (local stats).
    E = mo.n_experts
    density = F.one_hot(top_e[..., 0], E).float().mean(dim=0)
    prob_mean = probs.mean(dim=0)
    aux = E * torch.sum(density * prob_mean)
    return top_w, top_e, aux


def _moe_dense_fallback(p, x, cfg):
    """Every expert on every token, gated by the routing weights."""
    B, S, d = x.shape
    mo = cfg.moe
    cdt = torch_dtype(cfg.compute_dtype)
    xf = x.reshape(-1, d).to(cdt)
    top_w, top_e, aux = _route(xf, p["router"], mo)
    h = F.silu(torch.einsum("td,edf->tef", xf, p["w_g"].to(cdt)))
    u = torch.einsum("td,edf->tef", xf, p["w_u"].to(cdt))
    outs = torch.einsum("tef,efd->ted", h * u, p["w_o"].to(cdt))
    gates = torch.zeros((xf.shape[0], mo.n_experts), dtype=cdt,
                        device=x.device).scatter_(1, top_e, top_w.to(cdt))
    y = torch.einsum("te,ted->td", gates, outs)
    if mo.n_shared:
        y = y + (F.silu(xf @ p["sh_g"].to(cdt))
                 * (xf @ p["sh_u"].to(cdt))) @ p["sh_o"].to(cdt)
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_apply(p, x, *, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y, aux_loss)."""
    return _moe_dense_fallback(p, x, cfg)
