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
shards with explicit collectives over the mesh axes the active rules give
(``model`` under the default rules), where the reference puts its
logical-axis constraints.  Each rank holds its ``qkv`` columns of the
q/k/v projections and its rows of ``wo`` and projects its batch rows with
them; the activations move, never the weights.  'seq' mode exchanges q
from columns to this rank's query rows (``seq_shard``, all heads), gathers
K/V whole, attends (sliding-window attention over the rows' windows only)
and exchanges the output rows back to columns; 'heads' mode
(:func:`set_attn_sharding`) pads the GQA groups to G'
(:func:`_heads_padding`), exchanges q to the real heads among this rank's
padded heads (``heads_shard``) and repeats K/V to them; either way the
output columns meet this rank's rows of ``wo`` and the partial outputs
are added over ``model``.  A decode step gathers its (B, 1, ·)
projections, writes its slot on the rank that holds it and runs split-K
over the cache length (``kv_seq``, over (``data``, ``model``) under the
dry run's ``long_500k`` rules), its softmax max and sums taken across
ranks.  MLA keeps ``w_dkv`` whole and, in decode, its absorbed form.
:func:`swiglu_apply` shards d_ff over ``dff``.  In training every
exchange sends its gradient back the way it came, the all-reduces pass
theirs through, the inputs' gradients leave the regions partial over
``model`` and the split weights' as their shards; the decode
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
from .sharding import (ACT, all_reduce, axes_bounds, axis_rank, axis_size,
                       current_mesh, exchange, is_dtensor, mixer_region,
                       one_axis, rank_chunks, region, rule_axes)

NEG_POS = -(10 ** 9)   # position of a KV pad slot: before every query


class PDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    scale: float = 1.0          # stddev multiplier on 1/sqrt(fan_in)
    init: str = "normal"        # normal | zeros | ones


def is_pdef(x) -> bool:
    return isinstance(x, PDef)


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


def axes_from_defs(defs):
    """The logical axes of a tree of PDef leaves, in its structure."""
    return tree_map(lambda pd: pd.axes, defs)


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


def local_attention(q, k, v, q_pos, kv_pos, *, window: int, prev=None):
    """Chunked sliding-window causal attention: O(S·2W) compute and memory.

    The sequence is cut into W-sized chunks; chunk i attends to chunks
    {i-1, i} with an exact (q_pos - kv_pos) ∈ [0, W) mask.  ``prev``: the
    (K, V, positions) of the W slots before the first chunk, which it
    attends to as well (a mesh rank's rows past the start of the
    sequence); none by default.
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
    if prev is None:
        k0, v0 = torch.zeros_like(kc[:, :1]), torch.zeros_like(vc[:, :1])
    else:
        k0, v0 = (t.reshape(B, 1, W, Hkv, dh) for t in prev[:2])
    kprev = torch.cat([k0, kc[:, :-1]], dim=1)
    vprev = torch.cat([v0, vc[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kc], dim=2)               # (B, nc, 2W, Hkv, dh)
    v2 = torch.cat([vprev, vc], dim=2)
    s = torch.einsum("bcwkgd,bctkd->bckgwt", qc.float(), k2.float()) * scale
    qp = q_pos.reshape(nc, W)
    kp = kv_pos.reshape(nc, W)
    p0 = torch.full_like(kp[:1], NEG_POS) if prev is None \
        else prev[2].reshape(1, W)
    kp_prev = torch.cat([p0, kp[:-1]], dim=0)
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
# a cross attention's cache: the encoder's K/V, whole over its positions
XATTN_CACHE_AXES = {"k": ("batch", None, "heads", None),
                    "v": ("batch", None, "heads", None)}

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


ATTN_REGION_AXES = {"wq": (None, "qkv"), "wk": (None, "qkv"),
                    "wv": (None, "qkv"), "wo": ("qkv", None),
                    "bq": ("qkv",), "bk": ("qkv",), "bv": ("qkv",),
                    "q_norm": (None,), "k_norm": (None,)}


def attn_apply(p, x, *, cfg, mode: str, cache=None, pos=None,
               local: bool = False, mesh=None, kv_len=None):
    """x: (B, S, D).  Returns (y, new_cache); a decode step writes its K/V
    into slot ``pos`` of ``cache`` in place.

    On DTensors (a model on a mesh) it runs as a region over local shards
    (:func:`~repro_torch.models.sharding.mixer_region`), which calls it
    back with ``mesh`` set: then ``p`` holds this rank's columns of
    ``wq``/``wk``/``wv`` (and the biases) and its rows of ``wo`` (split
    over ``qkv``), ``x`` this rank's batch rows, and a decode step's
    ``cache`` this rank's slots of a cache of ``kv_len`` slots split over
    ``kv_seq`` (:func:`_attn_on_mesh`)."""
    if is_dtensor(x):
        inplace = ("k", "v") if mode == "decode" else ()
        return mixer_region(attn_apply, p, x, axes=ATTN_REGION_AXES,
                            cache=cache, cache_axes=KV_CACHE_AXES,
                            inplace=inplace, place=False,
                            split=_attn_split(cfg, mode, local),
                            cfg=cfg, mode=mode, pos=pos, local=local,
                            kv_len=None if cache is None
                            else cache["k"].shape[1])
    if mesh is not None:
        return _attn_on_mesh(p, x, cfg=cfg, mode=mode, cache=cache, pos=pos,
                             local=local, mesh=mesh, kv_len=kv_len)
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
        k_cache = _write_slot(cache["k"], k, pos)
        v_cache = _write_slot(cache["v"], v, pos)
        o = decode_attention(q, k_cache, v_cache, pos,
                             window=cfg.local_window if local else 0)
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        positions = torch.arange(S, device=x.device)
        if cfg.rope_theta:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
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


MLA_REGION_AXES = {"wq": (None, "qkv"), "w_dkv": (None, "lora"),
                   "w_uk": ("lora", "qkv"), "w_uv": ("lora", "qkv"),
                   "wo": ("qkv", None)}


def mla_apply(p, x, *, cfg, mode: str, cache=None, pos=None, mesh=None,
              kv_len=None):
    """DeepSeek-style Multi-head Latent Attention with a compressed KV cache.

    Train/prefill: decompress K/V and run blockwise attention.  Decode: the
    absorbed form, scores and values in the rank-r latent space against a
    cache of c_kv (B, T, r) only.  On DTensors it runs as a region over
    local shards, as :func:`attn_apply` does, with ``wq``, ``w_uk``,
    ``w_uv`` and ``wo`` split over ``qkv`` and ``w_dkv`` whole
    (:func:`_mla_on_mesh`).
    """
    if is_dtensor(x):
        inplace = ("c_kv",) if mode == "decode" else ()
        return mixer_region(mla_apply, p, x, axes=MLA_REGION_AXES,
                            cache=cache, cache_axes=MLA_CACHE_AXES,
                            inplace=inplace, place=False,
                            split=_attn_split(cfg, mode, True),
                            cfg=cfg, mode=mode, pos=pos,
                            kv_len=None if cache is None
                            else cache["c_kv"].shape[1])
    if mesh is not None:
        return _mla_on_mesh(p, x, cfg=cfg, mode=mode, cache=cache, pos=pos,
                            mesh=mesh, kv_len=kv_len)
    B, S, D = x.shape
    H, dh, r = cfg.n_heads, cfg.head_dim, cfg.kv_lora_rank
    cdt = torch_dtype(cfg.compute_dtype)
    xq = x.to(cdt)
    q = (xq @ p["wq"].to(cdt)).reshape(B, S, H, dh)
    c_kv = xq @ p["w_dkv"].to(cdt)                          # (B, S, r)

    if mode == "decode":
        c_cache = _write_slot(cache["c_kv"], c_kv, pos)
        c_comp = c_cache.to(cdt)
        wuk = p["w_uk"].to(cdt).reshape(r, H, dh)
        wuv = p["w_uv"].to(cdt).reshape(r, H, dh)
        q_lat = torch.einsum("bshd,rhd->bshr", q, wuk)      # absorb W_uk into q
        s = torch.einsum("bshr,btr->bhst", q_lat.float(),
                         c_comp.float()) / math.sqrt(dh)
        idx = torch.arange(c_cache.shape[1], device=x.device)
        s = s.masked_fill(~(idx <= pos), -math.inf)
        pr = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", pr.to(cdt), c_comp)
        o = torch.einsum("bshr,rhd->bshd", o_lat, wuv)
        new_cache = {"c_kv": c_cache}
    else:
        k = (c_kv @ p["w_uk"].to(cdt)).reshape(B, S, H, dh)
        v = (c_kv @ p["w_uv"].to(cdt)).reshape(B, S, H, dh)
        positions = torch.arange(S, device=x.device)
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
    activation shards d_ff over the ``dff`` rule's axes (``model``:
    Megatron tensor parallelism, the reference's ``logical(g * u, "batch",
    None, "dff")``) and the output's partial sums are added over them."""
    if is_dtensor(x):
        mesh = current_mesh()
        return region(lambda x, wg, wu, wo: swiglu_apply(
                          {"wg": wg, "wu": wu, "wo": wo}, x, cfg=cfg,
                          mesh=mesh),
                      (x, p["wg"], p["wu"], p["wo"]),
                      (ACT,) + tuple(SWIGLU_REGION_AXES[k]
                                     for k in ("wg", "wu", "wo")),
                      (ACT,), split=rule_axes("dff"))
    cdt = torch_dtype(cfg.compute_dtype)
    xq = x.to(cdt)
    g = F.silu(xq @ p["wg"].to(cdt))
    u = xq @ p["wu"].to(cdt)
    y = (g * u) @ p["wo"].to(cdt)
    if mesh is not None:
        y = all_reduce(y, mesh, rule_axes("dff", mesh))
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention under a mesh (local shards, explicit collectives over 'model')
# ---------------------------------------------------------------------------

def _write_slot_split(cache: torch.Tensor, new: torch.Tensor, pos: int,
                      kv_len: int, mesh) -> int:
    """Write the one-step ``new`` into global slot ``pos`` of a cache whose
    ``kv_len`` slots are split over the ``kv_seq`` rule's axes (``cache``
    is this rank's chunk, written in place only on the rank that holds
    ``pos``).  Returns the chunk's first global slot."""
    if not 0 <= pos < kv_len:
        raise IndexError(f"decode position {pos} outside a cache of "
                         f"{kv_len} slots")
    lo, hi = axes_bounds(kv_len, mesh, rule_axes("kv_seq", mesh))
    if lo <= pos < hi:
        cache[:, pos - lo] = new[:, 0].to(cache.dtype)
    return lo


def _split_softmax(s: torch.Tensor, mesh, axes=None) -> torch.Tensor:
    """This rank's columns of softmax(s, -1) when the last axis of the
    scores ``s`` (float32, masked with -inf) is split over ``axes`` (by
    default the ``kv_seq`` rule's): the max and the sum are taken across
    the ranks."""
    axes = rule_axes("kv_seq", mesh) if axes is None else axes
    if s.shape[-1]:
        m = s.amax(dim=-1)
    else:
        m = s.new_full(s.shape[:-1], -math.inf)
    m = all_reduce(m, mesh, axes, op=torch.distributed.ReduceOp.MAX)
    p = torch.exp(s - m[..., None])
    return p / all_reduce(p.sum(dim=-1), mesh, axes)[..., None]


def _decode_attention_split(q, k_cache, v_cache, pos: int, lo: int, mesh, *,
                            window: int = 0, axes=None):
    """:func:`decode_attention` against this rank's chunk of the cache
    (global slots ``lo``..), the softmax and the value sum across ranks:
    the reference's split-K decode over ``kv_seq`` (or over ``axes``; a
    ``pos`` at the last slot masks nothing, as a cross attention reads)."""
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
    axes = rule_axes("kv_seq", mesh) if axes is None else axes
    p = _split_softmax(s, mesh, axes)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return all_reduce(out, mesh, axes).reshape(B, 1, H, dh).to(q.dtype)


def _heads_mode(H: int, Hkv: int, seq_only: bool, mesh):
    """The padded group count G' of 'heads' mode on ``mesh``, or None where
    the region splits the query rows instead ('seq' mode, local
    attention, MLA, or a padding beyond 25%)."""
    if seq_only or ATTN_SHARDING[0] != "heads":
        return None
    return _heads_padding(H, Hkv, axis_size(mesh, rule_axes("heads_shard", mesh)))


def _attn_split(cfg, mode: str, seq_only: bool):
    """The mesh axes whose ranks do different work in an attention region:
    the ``qkv`` rule's (each rank's projection columns), with the
    ``kv_seq`` rule's in a decode step, else the ``heads_shard`` rule's in
    'heads' mode and the ``seq_shard`` rule's in 'seq' mode."""
    mesh = current_mesh()
    if mode == "decode":
        work = rule_axes("kv_seq", mesh)
    else:
        gp = _heads_mode(cfg.n_heads, cfg.n_kv_heads, seq_only, mesh)
        work = rule_axes("heads_shard" if gp else "seq_shard", mesh)
    return tuple(dict.fromkeys(rule_axes("qkv", mesh) + work))


def _same_axis(mesh, name: str, qa):
    """Raise unless rule ``name`` (query rows, heads) splits over the
    projections' ``qkv`` axis ``qa`` (or nothing): the regions exchange
    between the two splits over one mesh axis."""
    axis = one_axis(name, mesh)
    if axis and axis != qa:
        raise ValueError(f"attention splits {name!r} over {axis} and its "
                         f"projections over {qa}; the regions exchange "
                         f"between them over one mesh axis")


def _gather_cols(t, cols, mesh, axis):
    """The whole last dim of ``t`` on every rank, from each rank's columns
    ``cols[r]`` (backward: each rank's columns of the summed gradient)."""
    return exchange(t, mesh, axis, -1, cols, -1, [(0, cols[-1][1])] * len(cols))


def _real_heads(p0: int, p1: int, G: int, gp: int) -> Tuple[int, int]:
    """The real heads [ra, rb) among the padded heads [p0, p1) of 'heads'
    mode (GQA groups of G padded to gp): a contiguous run, since padding
    only inserts heads."""
    def real_before(ph):
        return (ph // gp) * G + min(ph % gp, G)
    return real_before(p0), real_before(p1)


def _local_rows(q, k, v, positions, lo: int, hi: int, W: int):
    """Sliding-window attention of the query rows [lo, hi) (``q``) against
    the whole K/V: :func:`local_attention` over those rows, the W slots
    before ``lo`` (padded where ``lo`` < W) as the first chunk's
    predecessor, so each row meets its window and no more."""
    a = max(lo - W, 0)
    pad = W - (lo - a)
    prev = (F.pad(k[:, a:lo], (0, 0, 0, 0, pad, 0)),
            F.pad(v[:, a:lo], (0, 0, 0, 0, pad, 0)),
            F.pad(positions[a:lo], (pad, 0), value=NEG_POS))
    return local_attention(q, k[:, lo:hi], v[:, lo:hi], positions[lo:hi],
                           positions[lo:hi], window=W, prev=prev)


def _attn_prefill_mesh(q, k, v, *, prep, qcols, kcols, wo, cfg, cdt, local,
                       mesh, axis, out_dtype, heads_mode=True, causal=True):
    """Prefill/train attention from this rank's projection columns ``q``
    (``qcols``), (B, S, ·), and ``k``, ``v`` (``kcols``), (B, T, ·): T = S
    but for a cross attention (``causal`` False, as the encoder's), split
    over ``axis`` as the reference constrains it.  K/V are gathered whole.
    ``prep(q, k, q_pos, kv_pos)`` turns the exchanged projections into
    heads (qk-norm, RoPE).

    'seq' mode: ``q`` is exchanged from columns to this rank's chunk of
    query rows (``seq_shard``, all heads: the reference's
    ``("batch", "seq_shard", "heads", None)``), attended against all keys,
    and the output rows exchanged back to columns.  'heads' mode
    (non-local attention, ``ATTN_SHARDING`` 'heads' and a padding within
    25%): the GQA groups padded to G' with zero queries; ``q`` exchanged to
    the real heads among this rank's padded heads, K/V repeated to them,
    the padded heads attended and the real heads' outputs exchanged back
    to columns.  Either way this rank's output columns meet its rows of
    ``wo`` and the partial outputs are added over ``axis``.  Returns (y,
    the unrepeated K/V whole as the prefill cache)."""
    B, S = q.shape[:2]
    T = k.shape[1]
    H, dh = cfg.n_heads, cfg.head_dim
    Hkv = kcols[-1][1] // dh            # MLA decompresses K/V to H heads
    me = axis_rank(mesh, axis) if axis else 0
    positions = torch.arange(S, device=q.device)
    kv_pos = positions if T == S else torch.arange(T, device=q.device)
    k = _gather_cols(k, kcols, mesh, axis)
    v = _gather_cols(v, kcols, mesh, axis).reshape(B, T, Hkv, dh)
    gp = _heads_mode(H, Hkv, local or not heads_mode, mesh)
    if gp is None:
        _same_axis(mesh, "seq_shard", axis)
        rows = rank_chunks(S, mesh, axis)
        lo, hi = rows[me]
        q = exchange(q, mesh, axis, -1, qcols, 1, rows)
        q, k = prep(q, k, positions[lo:hi], kv_pos)
        if local:
            o = _local_rows(q, k, v, positions, lo, hi, cfg.local_window)
        else:
            o = blockwise_attention(q, k, v, positions[lo:hi], kv_pos,
                                    causal=causal)
        o = exchange(o.reshape(B, hi - lo, H * dh), mesh, axis, 1, rows, -1,
                     qcols)
    else:
        _same_axis(mesh, "heads_shard", axis)
        G, m = H // Hkv, len(qcols)
        hs = Hkv * gp // m
        spans = [_real_heads(r * hs, (r + 1) * hs, G, gp) for r in range(m)]
        ra, rb = spans[me]
        real = [(a * dh, b * dh) for a, b in spans]
        q = exchange(q, mesh, axis, -1, qcols, -1, real)
        q, k = prep(q, k, positions, positions)
        own = range(me * hs, (me + 1) * hs)
        qi = [(ph // gp) * G + ph % gp - ra if ph % gp < G else rb - ra
              for ph in own]
        ki = [ph // gp for ph in own]
        qp = torch.cat([q, q.new_zeros(B, S, 1, dh)], dim=2)[:, :, qi]
        o = blockwise_attention(qp, k[:, :, ki], v[:, :, ki], positions,
                                positions, causal=True)
        keep = [i for i, ph in enumerate(own) if ph % gp < G]
        o = exchange(o[:, :, keep].reshape(B, S, (rb - ra) * dh), mesh, axis,
                     -1, real, -1, qcols)
    y = all_reduce(o @ wo.to(cdt), mesh, axis).to(out_dtype)
    return y, {"k": k, "v": v}


def _attn_on_mesh(p, x, *, cfg, mode, cache, pos, local, mesh, kv_len):
    """:func:`attn_apply` on this rank's batch rows and its ``qkv`` shard of
    the projections.  Each rank projects with its own columns of
    ``wq``/``wk``/``wv``; the activations move instead of the weights.
    A decode step gathers the (B, 1, ·) projections over ``qkv``, writes
    its slot on the rank that holds it and runs split-K over ``kv_seq``;
    prefill and training run :func:`_attn_prefill_mesh`.  Qwen3-4B's 8 KV
    heads do not divide a 16-way axis, so the split runs along the
    flattened columns and the head math (qk-norm, RoPE) after the
    exchange, the reference's layout."""
    B, S, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = torch_dtype(cfg.compute_dtype)
    axis = one_axis("qkv", mesh)
    me = axis_rank(mesh, axis) if axis else 0
    qcols = rank_chunks(H * dh, mesh, axis)
    kcols = rank_chunks(Hkv * dh, mesh, axis)
    xq = x.to(cdt)
    q = xq @ p["wq"].to(cdt)
    k = xq @ p["wk"].to(cdt)
    v = xq @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)

    def prep(q, k, q_pos, kv_pos):
        q = q.reshape(B, q.shape[1], -1, dh)
        k = k.reshape(B, k.shape[1], Hkv, dh)
        if cfg.qk_norm:
            q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
        if cfg.rope_theta:
            q = rope(q, q_pos, cfg.rope_theta)
            k = rope(k, kv_pos, cfg.rope_theta)
        return q, k

    if mode == "decode":
        at = torch.tensor([pos], device=x.device)
        q, k = prep(_gather_cols(q, qcols, mesh, axis),
                    _gather_cols(k, kcols, mesh, axis), at, at)
        v = _gather_cols(v, kcols, mesh, axis).reshape(B, 1, Hkv, dh)
        lo = _write_slot_split(cache["k"], k, pos, kv_len, mesh)
        _write_slot_split(cache["v"], v, pos, kv_len, mesh)
        o = _decode_attention_split(q, cache["k"], cache["v"], pos, lo, mesh,
                                    window=cfg.local_window if local else 0)
        c0, c1 = qcols[me]         # this rank's columns meet its wo rows
        y = o.reshape(B, 1, H * dh)[..., c0:c1] @ p["wo"].to(cdt)
        return all_reduce(y, mesh, axis).to(x.dtype), cache
    y, kv = _attn_prefill_mesh(q, k, v, prep=prep, qcols=qcols, kcols=kcols,
                               wo=p["wo"], cfg=cfg, cdt=cdt, local=local,
                               mesh=mesh, axis=axis, out_dtype=x.dtype)
    return y, (kv if mode == "prefill" else None)


def bidir_attn_mesh(p, x, *, cfg, kv=None, keep_kv=False):
    """Bidirectional (encoder) or cross attention (K/V from ``kv``) of the
    DTensor ``x``: a region over each rank's ``qkv`` shard of the
    projections (:func:`_bidir_on_mesh`).  Returns (y, the cross
    attention's K/V with ``keep_kv``, else None)."""
    return mixer_region(_bidir_on_mesh, p, x, axes=ATTN_REGION_AXES,
                        cache_axes=XATTN_CACHE_AXES,
                        split=_attn_split(cfg, "train", True),
                        acts=None if kv is None else {"kv": kv}, cfg=cfg,
                        keep_kv=keep_kv)


def xattn_decode_mesh(p, x, k_cache, v_cache, *, cfg):
    """A decode step's cross attention of the DTensor ``x`` against the
    encoder's cached K/V: a region (:func:`_xattn_decode_mesh`)."""
    return mixer_region(_xattn_decode_mesh, p, x, axes=ATTN_REGION_AXES,
                        cache={"k": k_cache, "v": v_cache},
                        cache_axes=XATTN_CACHE_AXES,
                        split=rule_axes("qkv"), cfg=cfg)[0]


def _bidir_on_mesh(p, x, *, cfg, cache, mesh, kv=None, keep_kv=False):
    """:func:`~repro_torch.models.transformer._bidir_attn_apply` on this
    rank's batch rows, as the decoder's 'seq' region
    (:func:`_attn_prefill_mesh`): each rank projects with its columns of
    ``wq``/``wk``/``wv``, q moves from columns to this rank's query rows
    and the output back, K/V (of
    ``x``, or of the encoder output ``kv``) are gathered whole, and this
    rank's rows of ``wo`` meet its output columns before an all-reduce.
    With ``keep_kv`` the gathered K/V are returned as the cross
    attention's cache, (B, T, Hkv, dh) each."""
    B, S, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = torch_dtype(cfg.compute_dtype)
    axis = one_axis("qkv", mesh)
    xq = x.to(cdt)
    src = xq if kv is None else kv.to(cdt)
    T = src.shape[1]

    def prep(q, k, q_pos, kv_pos):
        return q.reshape(B, q.shape[1], H, dh), k.reshape(B, T, Hkv, dh)

    y, kvc = _attn_prefill_mesh(
        xq @ p["wq"].to(cdt), src @ p["wk"].to(cdt), src @ p["wv"].to(cdt),
        prep=prep, qcols=rank_chunks(H * dh, mesh, axis),
        kcols=rank_chunks(Hkv * dh, mesh, axis), wo=p["wo"], cfg=cfg, cdt=cdt,
        local=False, mesh=mesh, axis=axis, out_dtype=x.dtype,
        heads_mode=False, causal=False)
    return y, (kvc if keep_kv else None)


def _xattn_decode_mesh(p, x, *, cfg, cache, mesh):
    """:func:`~repro_torch.models.transformer._xattn_cached` on this rank's
    batch rows, as the decoder's decode step: each rank projects its
    ``wq`` columns, the (B, 1, ·) queries are gathered whole, each rank
    attends over its rows of the encoder positions (the cache is whole on
    every rank) by the decoder's split-K decode over ``qkv``'s axis
    (:func:`_decode_attention_split`), and its output columns meet its rows
    of ``wo`` before an all-reduce."""
    B = x.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim
    cdt = torch_dtype(cfg.compute_dtype)
    axis = one_axis("qkv", mesh)
    me = axis_rank(mesh, axis) if axis else 0
    qcols = rank_chunks(H * dh, mesh, axis)
    q = _gather_cols(x.to(cdt) @ p["wq"].to(cdt), qcols, mesh, axis)
    T = cache["k"].shape[1]
    lo, hi = rank_chunks(T, mesh, axis)[me]
    o = _decode_attention_split(q.reshape(B, 1, H, dh), cache["k"][:, lo:hi],
                                cache["v"][:, lo:hi], T - 1, lo, mesh,
                                axes=axis)
    c0, c1 = qcols[me]
    y = o.reshape(B, 1, H * dh)[..., c0:c1] @ p["wo"].to(cdt)
    return all_reduce(y, mesh, axis).to(x.dtype), None


def _pad_heads(t, c0: int, c1: int, dh: int):
    """The columns [c0, c1) of a flattened (heads, dh) last dim, zero-padded
    to whole heads and split into them: (..., heads, dh)."""
    h0, h1 = c0 // dh, -(-c1 // dh)
    t = F.pad(t, (c0 - h0 * dh, h1 * dh - c1))
    return t.reshape(t.shape[:-1] + (h1 - h0, dh))


def _mla_on_mesh(p, x, *, cfg, mode, cache, pos, mesh, kv_len):
    """:func:`mla_apply` on this rank's batch rows: its ``qkv`` columns of
    ``wq``, ``w_uk`` and ``w_uv`` and its rows of ``wo``; ``w_dkv`` whole
    (``lora`` replicated).  Each rank computes the latent c_kv of its rows
    (of the sequence; of the batch in a decode step) and the rows are
    gathered.  Prefill and training decompress this rank's columns of K/V
    and run :func:`_attn_prefill_mesh` in 'seq' mode.  A decode step keeps the
    absorbed form: each rank absorbs its columns of ``w_uk`` into its
    columns of q (the heads they touch, zero-padded), the latent queries
    are added over ``qkv`` into every head, split-K runs over ``kv_seq``
    as before, and each rank expands the latent output through its
    columns of ``w_uv`` into its columns of ``wo``'s input."""
    B, S, D = x.shape
    H, dh, r = cfg.n_heads, cfg.head_dim, cfg.kv_lora_rank
    cdt = torch_dtype(cfg.compute_dtype)
    if rule_axes("lora", mesh):
        raise ValueError("MLA on a mesh keeps its latent rank whole; the "
                         "'lora' rule must name no mesh axis")
    axis = one_axis("qkv", mesh)
    me = axis_rank(mesh, axis) if axis else 0
    qcols = rank_chunks(H * dh, mesh, axis)
    c0, c1 = qcols[me]
    xq = x.to(cdt)
    q = xq @ p["wq"].to(cdt)
    # the latent by rows over ``axis``, then gathered whole: the sequence's
    # rows (where the cache's ``kv_seq`` rows lie), a decode step's one row
    # by batch rows
    dim = 0 if mode == "decode" else 1
    rows = rank_chunks(x.shape[dim], mesh, axis)
    lo, hi = rows[me]
    c_kv = exchange(xq.narrow(dim, lo, hi - lo) @ p["w_dkv"].to(cdt), mesh,
                    axis, dim, rows, dim, [(0, x.shape[dim])] * len(rows))

    if mode == "decode":
        c_cache = cache["c_kv"]
        lo = _write_slot_split(c_cache, c_kv, pos, kv_len, mesh)
        c_comp = c_cache.to(cdt)
        h0 = c0 // dh
        wuk = _pad_heads(p["w_uk"].to(cdt), c0, c1, dh)       # (r, nh, dh)
        q_lat = torch.einsum("bshd,rhd->bshr", _pad_heads(q, c0, c1, dh), wuk)
        q_lat = F.pad(q_lat, (0, 0, h0, H - h0 - q_lat.shape[2]))
        q_lat = all_reduce(q_lat, mesh, axis)                # (B, 1, H, r)
        s = torch.einsum("bshr,btr->bhst", q_lat.float(),
                         c_comp.float()) / math.sqrt(dh)
        idx = torch.arange(lo, lo + c_cache.shape[1], device=x.device)
        s = s.masked_fill(~(idx <= pos), -math.inf)
        pr = _split_softmax(s, mesh)     # split-K: the softmax across ranks
        o_lat = all_reduce(torch.einsum("bhst,btr->bshr", pr.to(cdt), c_comp),
                           mesh, rule_axes("kv_seq"))
        wuv = _pad_heads(p["w_uv"].to(cdt), c0, c1, dh)
        o = torch.einsum("bshr,rhd->bshd", o_lat[:, :, h0:h0 + wuv.shape[1]],
                         wuv).reshape(B, S, -1)
        o = o[..., c0 - h0 * dh:c1 - h0 * dh]
        y = all_reduce(o @ p["wo"].to(cdt), mesh, axis).to(x.dtype)
        return y, {"c_kv": c_cache}
    k = c_kv @ p["w_uk"].to(cdt)
    v = c_kv @ p["w_uv"].to(cdt)

    def prep(q, k, q_pos, kv_pos):
        return (q.reshape(B, q.shape[1], H, dh), k.reshape(B, S, H, dh))

    y, _ = _attn_prefill_mesh(q, k, v, prep=prep, qcols=qcols, kcols=qcols,
                              wo=p["wo"], cfg=cfg, cdt=cdt, local=False,
                              mesh=mesh, axis=axis, out_dtype=x.dtype,
                              heads_mode=False)
    return y, ({"c_kv": c_kv} if mode == "prefill" else None)
