"""Core layers: norms, RoPE, memory-efficient attention (causal / local /
decode), GQA and MLA blocks, SwiGLU: the port of ``repro.models.layers``.

Parameters are single-sourced as ``PDef`` leaves (shape, logical axes, init
scale); :func:`init_from_defs` draws real tensors from an explicit
``torch.Generator``.  The math is plain functions over a dict of tensors
``p``, computed where the reference computes it: weights cast to the
compute dtype on use, attention scores and softmax in float32 (the
reference's ``preferred_element_type``), norms and RoPE angles in float32.
Attention stays plain torch ops, as the reference's is jnp, not Pallas.

On a mesh (DTensor inputs) the attention blocks run as regions over local
shards with explicit collectives over ``model``, where the reference puts
its logical-axis constraints: 'seq' mode splits the query rows
(``seq_shard``) and gathers the output rows; 'heads' mode
(:func:`set_attn_sharding`) pads the GQA groups to G' (:func:`_heads_padding`),
repeats K/V, splits the padded heads (``heads_shard``) and adds the
partial outputs; a decode step writes its slot on the rank that holds it
and runs split-K over the cache length (``kv_seq``), its softmax max and
sums taken across ranks.  :func:`swiglu_apply` shards d_ff over ``model``
(``dff``).  In training the 'seq' output gather hands each rank its rows'
gradient, the 'heads' and SwiGLU all-reduces pass theirs through, and the
inputs' gradients leave the regions partial over ``model``; the decode
paths are not trained.  Two behaviours differ from the reference on purpose:

* :func:`blockwise_attention` masks its KV padding in causal mode too (the
  reference masks it only when ``causal=False``, so zero-padded keys enter
  every causal softmax whose length is not a multiple of ``kv_block``).
* The padded-head path pads ``wo`` group by group, as the queries are
  padded; the reference appends its zero ``wo`` rows after the last head,
  so with more than one KV head padded and real heads meet the wrong rows.
  Its prefill cache is the unrepeated K/V (Hkv heads, the layout
  ``cache_defs`` and the decode step use); the reference's holds the
  repeated Hkv·G' heads.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.kron_matvec._layout import resolve_device

from .config import torch_dtype
from .sharding import (ACT, all_gather_dim, all_reduce, axis_rank, axis_size,
                       chunk_bounds, current_mesh, is_dtensor, mixer_region,
                       region)

NEG_POS = -(10 ** 9)   # position of a KV pad slot: before every query


class PDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    scale: float = 1.0          # stddev multiplier on 1/sqrt(fan_in)
    init: str = "normal"        # normal | zeros | ones


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of a nested dict/list tree (and on the matching
    leaves of the trees ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a nested dict/list tree, dict keys in sorted order (the
    order ``jax.tree_util`` flattens a dict in)."""
    return list(tree_paths(tree).values())


def tree_paths(tree, sep: str = "/", prefix: str = ""):
    """``{path: leaf}`` of a nested dict/list tree, a path being the dict
    keys and list indices down to the leaf joined by ``sep``, dict keys in
    sorted order."""
    if isinstance(tree, dict):
        return {n: x for k in sorted(tree)
                for n, x in tree_paths(tree[k], sep, f"{prefix}{k}{sep}").items()}
    if isinstance(tree, (list, tuple)):
        return {n: x for i, v in enumerate(tree)
                for n, x in tree_paths(v, sep, f"{prefix}{i}{sep}").items()}
    return {prefix[:-len(sep)]: tree}


def init_from_defs(defs, gen: torch.Generator, dtype=torch.float32,
                   device=None, place=None):
    """Materialize a tree of PDef leaves on ``device``: normal leaves drawn
    from ``gen`` (on the same device) with std ``scale/√fan_in``, fan_in the
    second-to-last axis (the last of a vector), one leaf after another with
    dict keys in sorted order.  ``place(pdef, tensor)``, when given, maps
    each leaf as soon as it is drawn (a mesh keeps its shard of it)."""
    dev = resolve_device(device)

    def make(pd: PDef) -> torch.Tensor:
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=dev)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=dev)
        fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        std = pd.scale / math.sqrt(max(fan_in, 1))
        w = torch.randn(pd.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.mul_(std).to(dtype)

    def build(t):
        if isinstance(t, dict):
            drawn = {k: build(t[k]) for k in sorted(t)}
            return {k: drawn[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return make(t) if place is None else place(t, make(t))

    return build(defs)


# ---------------------------------------------------------------------------
# Norms & RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6):
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def head_rms_norm(x, w, eps: float = 1e-6):
    """qk-norm: RMS over the head_dim axis of (..., H, dh)."""
    return rms_norm(x, w, eps)


def rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, dh) with positions (S,) (one entry for a decode step)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # (S, half)
    cos = torch.cos(ang)[..., None, :]                           # over H
    sin = torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin, x1f * sin + x2f * cos],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Memory-efficient attention: online softmax over KV blocks
# ---------------------------------------------------------------------------

def blockwise_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                        window: int = 0, kv_block: int = 1024):
    """softmax(QKᵀ/√dh)V without materializing the S×T score matrix.

    q: (B, S, H, dh);  k, v: (B, T, Hkv, dh);  GQA via head grouping.
    q_pos: (S,), kv_pos: (T,) absolute positions for the causal/local masks.
    K/V are padded to a multiple of ``kv_block``; the pad slots are masked
    whatever the mode.
    """
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    nkv = -(-T // kv_block)
    pad = nkv * kv_block - T
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=NEG_POS)
    qg = q.reshape(B, S, Hkv, G, dh).float()
    m = torch.full((B, S, Hkv, G), -math.inf, device=q.device)
    l = torch.zeros((B, S, Hkv, G), device=q.device)
    acc = torch.zeros((B, S, Hkv, G, dh), device=q.device)
    for j in range(nkv):
        blk = slice(j * kv_block, (j + 1) * kv_block)
        kj, vj, pj = k[:, blk], v[:, blk], kv_pos[blk]
        s = torch.einsum("bskgd,btkd->bskgt", qg, kj.float()) * scale
        mask_qt = None
        if causal:
            mask_qt = pj[None, :] <= q_pos[:, None]              # (S, kvb)
        if window:
            w_mask = pj[None, :] > q_pos[:, None] - window
            mask_qt = w_mask if mask_qt is None else (mask_qt & w_mask)
        if pad:
            v_mask = (pj >= 0)[None, :].expand(S, -1)
            mask_qt = v_mask if mask_qt is None else (mask_qt & v_mask)
        if mask_qt is not None:
            s = s.masked_fill(~mask_qt[None, :, None, None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully-masked blocks keep m_new = -inf: guard exp(-inf - -inf)
        fin = torch.isfinite(m_new)
        corr = torch.where(fin, torch.exp(m - m_new), 0.0)
        p = torch.exp(s - torch.where(fin, m_new, 0.0)[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bskgt,btkd->bskgd", p.to(vj.dtype).float(), vj.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, S, H, dh).to(q.dtype)


def local_attention(q, k, v, q_pos, kv_pos, *, window: int):
    """Chunked sliding-window causal attention: O(S·2W) compute and memory.

    The sequence is cut into W-sized chunks; chunk i attends to chunks
    {i-1, i} with an exact (q_pos - kv_pos) ∈ [0, W) mask.
    """
    B, S0, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    W = window
    pad = (-S0) % W
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=NEG_POS)
        kv_pos = F.pad(kv_pos, (0, pad), value=2 * NEG_POS)
    S = S0 + pad
    nc = S // W
    scale = 1.0 / math.sqrt(dh)
    qc = q.reshape(B, nc, W, Hkv, G, dh)
    kc = k.reshape(B, nc, W, Hkv, dh)
    vc = v.reshape(B, nc, W, Hkv, dh)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kc], dim=2)               # (B, nc, 2W, Hkv, dh)
    v2 = torch.cat([vprev, vc], dim=2)
    s = torch.einsum("bcwkgd,bctkd->bckgwt", qc.float(), k2.float()) * scale
    qp = q_pos.reshape(nc, W)
    kp = kv_pos.reshape(nc, W)
    kp_prev = torch.cat([torch.full_like(kp[:1], NEG_POS), kp[:-1]], dim=0)
    kp2 = torch.cat([kp_prev, kp], dim=1)
    diff = qp[:, :, None] - kp2[:, None, :]           # (nc, W, 2W)
    mask = (diff >= 0) & (diff < W)
    s = s.masked_fill(~mask[None, :, None, None, :, :], -math.inf)
    # pad-safe softmax (fully-masked rows → 0, not NaN)
    smax = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - smax)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bckgwt,bctkd->bcwkgd", p.to(v2.dtype).float(),
                       v2.float())
    return out.reshape(B, S, H, dh)[:, :S0].to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0):
    """Single-step attention of q (B, 1, H, dh) against a cache (B, T, Hkv,
    dh) whose slots 0..pos are filled."""
    B, _, H, dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Hkv, G, dh)
    k_cache = k_cache.to(q.dtype)
    v_cache = v_cache.to(q.dtype)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    idx = torch.arange(T, device=q.device)
    mask = idx <= pos
    if window:
        mask = mask & (idx > pos - window)
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, dh).to(q.dtype)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, pos: int):
    """Write the one-step ``new`` (B, 1, ...) into slot ``pos`` of ``cache``
    in place; a slot past the cache raises (never clamps)."""
    if not 0 <= pos < cache.shape[1]:
        raise IndexError(f"decode position {pos} outside a cache of "
                         f"{cache.shape[1]} slots")
    cache[:, pos] = new[:, 0].to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# Attention blocks (GQA and MLA)
# ---------------------------------------------------------------------------

def attn_defs(cfg) -> Dict[str, Any]:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    defs: Dict[str, Any] = {
        "wq": PDef((d, qd), ("dmodel_fsdp", "qkv")),
        "wk": PDef((d, kvd), ("dmodel_fsdp", "qkv")),
        "wv": PDef((d, kvd), ("dmodel_fsdp", "qkv")),
        "wo": PDef((qd, d), ("qkv", "dmodel_fsdp")),
    }
    if cfg.qkv_bias:
        defs["bq"] = PDef((qd,), ("qkv",), init="zeros")
        defs["bk"] = PDef((kvd,), ("qkv",), init="zeros")
        defs["bv"] = PDef((kvd,), ("qkv",), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = PDef((cfg.head_dim,), (None,), init="ones")
        defs["k_norm"] = PDef((cfg.head_dim,), (None,), init="ones")
    return defs


# The caches' logical axes (``transformer.cache_defs`` builds its PDefs from
# these): K/V split over the cache length for split-K decode.
KV_CACHE_AXES = {"k": ("batch", "kv_seq", "heads", None),
                 "v": ("batch", "kv_seq", "heads", None)}
MLA_CACHE_AXES = {"c_kv": ("batch", "kv_seq", "lora")}

# Attention-region sharding mode under a mesh.  'seq' (default) shards the
# query sequence over 'model'.  'heads' pads the GQA group count so
# (Hkv · G') divides the model axis and shards heads instead, at
# (G'/G − 1) extra attention FLOPs; it falls back to 'seq' when the padding
# would waste more than 25%.
ATTN_SHARDING = ["seq"]


def set_attn_sharding(mode: str):
    assert mode in ("seq", "heads")
    ATTN_SHARDING[0] = mode


def _heads_padding(H: int, Hkv: int, msize: int):
    """Smallest padded group count G' with (Hkv·G') % msize == 0, or None."""
    G = H // Hkv
    gp = G
    while (Hkv * gp) % msize != 0:
        gp += 1
        if gp > 2 * G:
            return None
    return gp if gp / G <= 1.25 else None


def attn_apply(p, x, *, cfg, mode: str, cache=None, pos=None,
               local: bool = False, mesh=None, kv_len=None):
    """x: (B, S, D).  Returns (y, new_cache); a decode step writes its K/V
    into slot ``pos`` of ``cache`` in place.

    On DTensors (a model on a mesh) it runs as a region over local shards
    (:func:`~repro_torch.models.sharding.mixer_region`), which calls it
    back with ``mesh`` set: then ``p`` holds whole weights, ``x`` this
    rank's batch rows, and a decode step's ``cache`` this rank's slots of
    a cache of ``kv_len`` slots split over ``model``."""
    if is_dtensor(x):
        inplace = ("k", "v") if mode == "decode" else ()
        return mixer_region(attn_apply, p, x, cache=cache,
                            cache_axes=KV_CACHE_AXES, inplace=inplace,
                            place=False, cfg=cfg, mode=mode, pos=pos,
                            local=local,
                            kv_len=None if cache is None
                            else cache["k"].shape[1])
    B, S, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = torch_dtype(cfg.compute_dtype)
    xq = x.to(cdt)
    q = xq @ p["wq"].to(cdt)
    k = xq @ p["wk"].to(cdt)
    v = xq @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)

    if mode == "decode":
        if cfg.rope_theta:
            at = torch.tensor([pos], device=x.device)
            q = rope(q, at, cfg.rope_theta)
            k = rope(k, at, cfg.rope_theta)
        window = cfg.local_window if local else 0
        if mesh is not None:
            lo = _write_slot_split(cache["k"], k, pos, kv_len, mesh)
            _write_slot_split(cache["v"], v, pos, kv_len, mesh)
            o = _decode_attention_split(q, cache["k"], cache["v"], pos, lo,
                                        mesh, window=window)
            return (o.reshape(B, 1, H * dh) @ p["wo"].to(cdt)).to(x.dtype), cache
        k_cache = _write_slot(cache["k"], k, pos)
        v_cache = _write_slot(cache["v"], v, pos)
        o = decode_attention(q, k_cache, v_cache, pos, window=window)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        positions = torch.arange(S, device=x.device)
        if cfg.rope_theta:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        if mesh is not None:
            return _attn_prefill_mesh(p, q, k, v, positions, cfg=cfg, cdt=cdt,
                                      mode=mode, local=local, mesh=mesh,
                                      out_dtype=x.dtype)
        if local:
            o = local_attention(q, k, v, positions, positions,
                                window=cfg.local_window)
        else:
            o = blockwise_attention(q, k, v, positions, positions, causal=True)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
    y = o.reshape(B, S, H * dh) @ p["wo"].to(cdt)
    return y.to(x.dtype), new_cache


def mla_defs(cfg) -> Dict[str, Any]:
    d, qd, r = cfg.d_model, cfg.q_dim, cfg.kv_lora_rank
    return {
        "wq": PDef((d, qd), ("dmodel_fsdp", "qkv")),
        "w_dkv": PDef((d, r), ("dmodel_fsdp", "lora")),
        "w_uk": PDef((r, qd), ("lora", "qkv")),
        "w_uv": PDef((r, qd), ("lora", "qkv")),
        "wo": PDef((qd, d), ("qkv", "dmodel_fsdp")),
    }


def mla_apply(p, x, *, cfg, mode: str, cache=None, pos=None, mesh=None,
              kv_len=None):
    """DeepSeek-style Multi-head Latent Attention with a compressed KV cache.

    Train/prefill: decompress K/V and run blockwise attention.  Decode: the
    absorbed form, scores and values in the rank-r latent space against a
    cache of c_kv (B, T, r) only.  On DTensors it runs as a region over
    local shards, as :func:`attn_apply` does.
    """
    if is_dtensor(x):
        inplace = ("c_kv",) if mode == "decode" else ()
        return mixer_region(mla_apply, p, x, cache=cache,
                            cache_axes=MLA_CACHE_AXES, inplace=inplace,
                            place=False, cfg=cfg, mode=mode, pos=pos,
                            kv_len=None if cache is None
                            else cache["c_kv"].shape[1])
    B, S, D = x.shape
    H, dh, r = cfg.n_heads, cfg.head_dim, cfg.kv_lora_rank
    cdt = torch_dtype(cfg.compute_dtype)
    xq = x.to(cdt)
    q = (xq @ p["wq"].to(cdt)).reshape(B, S, H, dh)
    c_kv = xq @ p["w_dkv"].to(cdt)                          # (B, S, r)

    if mode == "decode":
        lo = 0
        if mesh is None:
            c_cache = _write_slot(cache["c_kv"], c_kv, pos)
        else:
            c_cache = cache["c_kv"]
            lo = _write_slot_split(c_cache, c_kv, pos, kv_len, mesh)
        c_comp = c_cache.to(cdt)
        wuk = p["w_uk"].to(cdt).reshape(r, H, dh)
        wuv = p["w_uv"].to(cdt).reshape(r, H, dh)
        q_lat = torch.einsum("bshd,rhd->bshr", q, wuk)      # absorb W_uk into q
        s = torch.einsum("bshr,btr->bhst", q_lat.float(),
                         c_comp.float()) / math.sqrt(dh)
        idx = torch.arange(lo, lo + c_cache.shape[1], device=x.device)
        s = s.masked_fill(~(idx <= pos), -math.inf)
        if mesh is None:
            pr = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("bhst,btr->bshr", pr.to(cdt), c_comp)
        else:     # split-K: this rank's slots, the softmax across ranks
            pr = _split_softmax(s, mesh)
            o_lat = all_reduce(torch.einsum("bhst,btr->bshr", pr.to(cdt),
                                            c_comp), mesh, "model")
        o = torch.einsum("bshr,rhd->bshd", o_lat, wuv)
        new_cache = {"c_kv": c_cache}
    else:
        k = (c_kv @ p["w_uk"].to(cdt)).reshape(B, S, H, dh)
        v = (c_kv @ p["w_uv"].to(cdt)).reshape(B, S, H, dh)
        positions = torch.arange(S, device=x.device)
        if mesh is not None:
            y, _ = _attn_prefill_mesh(p, q, k, v, positions, cfg=cfg, cdt=cdt,
                                      mode=mode, local=False, mesh=mesh,
                                      out_dtype=x.dtype, heads_mode=False)
            return y, ({"c_kv": c_kv} if mode == "prefill" else None)
        o = blockwise_attention(q, k, v, positions, positions, causal=True)
        new_cache = {"c_kv": c_kv} if mode == "prefill" else None
    y = o.reshape(B, S, H * dh) @ p["wo"].to(cdt)
    return y.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

def swiglu_defs(cfg) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wg": PDef((d, f), ("dmodel_fsdp", "dff")),
        "wu": PDef((d, f), ("dmodel_fsdp", "dff")),
        "wo": PDef((f, d), ("dff", "dmodel_fsdp")),
    }


SWIGLU_REGION_AXES = {"wg": (None, "dff"), "wu": (None, "dff"),
                      "wo": ("dff", None)}


def swiglu_apply(p, x, *, cfg, mesh=None):
    """SwiGLU; on DTensors a region (``local_map``) in which the hidden
    activation shards d_ff over ``model`` (Megatron tensor parallelism, the
    reference's ``logical(g * u, "batch", None, "dff")``) and the output's
    partial sums are added over ``model``."""
    if is_dtensor(x):
        mesh = current_mesh()
        return region(lambda x, wg, wu, wo: swiglu_apply(
                          {"wg": wg, "wu": wu, "wo": wo}, x, cfg=cfg,
                          mesh=mesh),
                      (x, p["wg"], p["wu"], p["wo"]),
                      (ACT,) + tuple(SWIGLU_REGION_AXES[k]
                                     for k in ("wg", "wu", "wo")),
                      (ACT,))
    cdt = torch_dtype(cfg.compute_dtype)
    xq = x.to(cdt)
    g = F.silu(xq @ p["wg"].to(cdt))
    u = xq @ p["wu"].to(cdt)
    y = (g * u) @ p["wo"].to(cdt)
    if mesh is not None:
        y = all_reduce(y, mesh, "model")
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention under a mesh (local shards, explicit collectives over 'model')
# ---------------------------------------------------------------------------

def _write_slot_split(cache: torch.Tensor, new: torch.Tensor, pos: int,
                      kv_len: int, mesh) -> int:
    """Write the one-step ``new`` into global slot ``pos`` of a cache whose
    ``kv_len`` slots are split over ``model`` (``cache`` is this rank's
    chunk, written in place only on the rank that holds ``pos``).  Returns
    the chunk's first global slot."""
    if not 0 <= pos < kv_len:
        raise IndexError(f"decode position {pos} outside a cache of "
                         f"{kv_len} slots")
    lo, hi = chunk_bounds(kv_len, axis_size(mesh, "model"),
                          axis_rank(mesh, "model"))
    if lo <= pos < hi:
        cache[:, pos - lo] = new[:, 0].to(cache.dtype)
    return lo


def _split_softmax(s: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's columns of softmax(s, -1) when the last axis of the
    scores ``s`` (float32, masked with -inf) is split over ``model``: the
    max and the sum are taken across the ranks."""
    if s.shape[-1]:
        m = s.amax(dim=-1)
    else:
        m = s.new_full(s.shape[:-1], -math.inf)
    m = all_reduce(m, mesh, "model", op=torch.distributed.ReduceOp.MAX)
    p = torch.exp(s - m[..., None])
    return p / all_reduce(p.sum(dim=-1), mesh, "model")[..., None]


def _decode_attention_split(q, k_cache, v_cache, pos: int, lo: int, mesh, *,
                            window: int = 0):
    """:func:`decode_attention` against this rank's chunk of the cache
    (global slots ``lo``..), the softmax and the value sum across ranks:
    the reference's split-K decode over ``kv_seq``."""
    B, _, H, dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Hkv, G, dh)
    k_cache = k_cache.to(q.dtype)
    v_cache = v_cache.to(q.dtype)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    idx = torch.arange(lo, lo + T, device=q.device)
    mask = idx <= pos
    if window:
        mask = mask & (idx > pos - window)
    s = s.masked_fill(~mask, -math.inf)
    p = _split_softmax(s, mesh)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return all_reduce(out, mesh, "model").reshape(B, 1, H, dh).to(q.dtype)


def _attn_prefill_mesh(p, q, k, v, positions, *, cfg, cdt, mode, local, mesh,
                       out_dtype, heads_mode=True):
    """Prefill/train attention on this rank's batch rows, split over
    ``model`` as the reference constrains it.

    'heads' mode (non-local attention, ``ATTN_SHARDING`` 'heads' and a
    padding within 25%): the GQA groups padded to G' with zero queries, K/V
    repeated to Hkv·G' heads, this rank's contiguous share of the padded
    heads attended, its rows of the padded ``wo`` applied and the partial
    outputs added over ``model``.  ``wo`` is padded group by group, the
    layout the padded queries have.  'seq' mode: this rank's chunk of
    query rows against all keys (``seq_shard``), the output rows gathered
    over ``model``.  Returns (y, the unrepeated K/V as the prefill cache).
    """
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    msize, rank = axis_size(mesh, "model"), axis_rank(mesh, "model")
    new_cache = {"k": k, "v": v} if mode == "prefill" else None
    gp = None
    if heads_mode and ATTN_SHARDING[0] == "heads" and not local:
        gp = _heads_padding(H, Hkv, msize)
    if gp is not None:
        G = H // Hkv
        Hp = Hkv * gp
        qp = F.pad(q.reshape(B, S, Hkv, G, dh), (0, 0, 0, gp - G)) \
            .reshape(B, S, Hp, dh)
        kp = torch.repeat_interleave(k, gp, dim=2)
        vp = torch.repeat_interleave(v, gp, dim=2)
        hs = Hp // msize
        h0 = rank * hs
        o = blockwise_attention(qp[:, :, h0:h0 + hs], kp[:, :, h0:h0 + hs],
                                vp[:, :, h0:h0 + hs], positions, positions,
                                causal=True)
        wo = F.pad(p["wo"].to(cdt).reshape(Hkv, G, dh, -1),
                   (0, 0, 0, 0, 0, gp - G)).reshape(Hp, dh, -1)
        y = o.reshape(B, S, hs * dh) @ wo[h0:h0 + hs].reshape(hs * dh, -1)
        return all_reduce(y, mesh, "model").to(out_dtype), new_cache
    lo, hi = chunk_bounds(S, msize, rank)
    o = blockwise_attention(q[:, lo:hi], k, v, positions[lo:hi], positions,
                            causal=True,
                            window=cfg.local_window if local else 0)
    y = o.reshape(B, hi - lo, H * dh) @ p["wo"].to(cdt)
    return all_gather_dim(y, 1, mesh, "model", S).to(out_dtype), new_cache
