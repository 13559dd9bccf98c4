"""Model assembly: the decoder over every block kind (+ an optional encoder),
its caches, and the prefill / decode entry points: the port of
``repro.models.transformer``'s serving path.

Layers come in pattern groups (``cfg.pattern`` repeated ``n_pattern_groups``
times, plus an optional tail) as in the reference, but unstacked: the
parameter and cache trees hold one dict per group in a list (``blocks``,
``tail_blocks``, ``encoder_blocks``), keyed inside a group by
``"{i}:{kind}"`` (and ``"{i}:xattn"`` for an encoder-decoder's cross
attention), and a Python loop over groups replaces ``jax.lax.scan``.

:class:`Model` holds the parameters as modules (one :class:`Block` per
layer) and runs on CUDA unless given ``device="cpu"``.  Two behaviours
differ from the reference on purpose:

* ``prefill(batch, cache_len)`` pads the self-attention caches (``k``,
  ``v`` of ``attn``/``attn_local``, ``c_kv`` of ``mla``) to ``cache_len``
  along their sequence axis, picked by key and block kind.  The reference
  pads by shape (``leaf.shape[1] == S``), which its group-stacked caches
  never match, so its decode steps overwrite the last prompt slot.
* ``decode_step`` raises when ``pos`` is past the cache instead of
  clamping the write.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels.kron_matvec._layout import resolve_device

from .config import ModelConfig, torch_dtype
from .layers import (PDef, attn_apply, attn_defs, blockwise_attention,
                     init_from_defs, mla_apply, mla_defs, rms_norm,
                     swiglu_apply, swiglu_defs, tree_map)
from .moe import moe_apply, moe_defs
from .recurrent import (mlstm_apply, mlstm_defs, rglru_apply, rglru_defs,
                        slstm_apply, slstm_defs)

MIXER_DEFS = {
    "attn": attn_defs, "attn_local": attn_defs, "attn_bidir": attn_defs,
    "mla": mla_defs, "rglru": rglru_defs, "mlstm": mlstm_defs,
    "slstm": slstm_defs,
}

SEQ_CACHE_KINDS = {"attn": ("k", "v"), "attn_local": ("k", "v"),
                   "mla": ("c_kv",)}
_KV_CACHE_KEYS = ("k", "v", "c_kv")   # stored in cache dtype; states stay fp32


def _block_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    d = {
        "norm1": PDef((cfg.d_model,), (None,), init="ones"),
        "mixer": MIXER_DEFS[kind](cfg),
    }
    if cfg.ffn == "swiglu" and cfg.d_ff:
        d["norm2"] = PDef((cfg.d_model,), (None,), init="ones")
        d["ffn"] = swiglu_defs(cfg)
    elif cfg.ffn == "moe" and cfg.moe is not None:
        d["norm2"] = PDef((cfg.d_model,), (None,), init="ones")
        d["ffn"] = moe_defs(cfg)
    return d


def _xattn_defs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"norm": PDef((cfg.d_model,), (None,), init="ones"),
            "attn": attn_defs(cfg)}


def _group_defs(cfg: ModelConfig, pattern, xattn: bool) -> Dict[str, Any]:
    g = {f"{i}:{kind}": _block_defs(cfg, kind) for i, kind in enumerate(pattern)}
    if xattn:
        for i, _ in enumerate(pattern):
            g[f"{i}:xattn"] = _xattn_defs(cfg)
    return g


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's PDef leaves (one group dict per list entry)."""
    d: Dict[str, Any] = {}
    if cfg.frontend == "none":
        d["embed"] = PDef((cfg.vocab_size, cfg.d_model), ("vocab", "dmodel_fsdp"))
    d["lm_head"] = PDef((cfg.d_model, cfg.vocab_size), ("dmodel_fsdp", "vocab"))
    d["final_norm"] = PDef((cfg.d_model,), (None,), init="ones")
    d["blocks"] = [_group_defs(cfg, cfg.pattern, bool(cfg.encoder_layers))
                   for _ in range(cfg.n_pattern_groups)]
    if cfg.n_tail:
        d["tail_blocks"] = [_group_defs(cfg, cfg.tail_pattern, False)
                            for _ in range(cfg.n_tail)]
    if cfg.encoder_layers:
        d["encoder_blocks"] = [_group_defs(cfg, ("attn_bidir",), False)
                               for _ in range(cfg.encoder_layers)]
        d["encoder_norm"] = PDef((cfg.d_model,), (None,), init="ones")
    return d


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _mixer_cache_defs(cfg: ModelConfig, kind: str, batch: int, seq: int):
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if kind in ("attn", "attn_local"):
        return {"k": PDef((batch, seq, Hkv, dh), ("batch", "kv_seq", "heads", None)),
                "v": PDef((batch, seq, Hkv, dh), ("batch", "kv_seq", "heads", None))}
    if kind == "mla":
        return {"c_kv": PDef((batch, seq, cfg.kv_lora_rank),
                             ("batch", "kv_seq", "lora"))}
    if kind == "rglru":
        w = cfg.rnn_state_dim or cfg.d_model
        return {"h": PDef((batch, w), ("batch", "rnn_state"))}
    if kind == "mlstm":
        return {"C": PDef((batch, H, dh, dh), ("batch", "heads", None, None)),
                "n": PDef((batch, H, dh), ("batch", "heads", None)),
                "m": PDef((batch, H), ("batch", "heads"))}
    if kind == "slstm":
        return {k: PDef((batch, H, dh), ("batch", "heads", None))
                for k in ("c", "n", "m", "h")}
    raise ValueError(kind)


def cache_defs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    def group(pattern, xattn):
        g = {f"{i}:{kind}": _mixer_cache_defs(cfg, kind, batch, seq)
             for i, kind in enumerate(pattern)}
        if xattn:  # decode-time cross-attn K/V from the encoder
            for i, _ in enumerate(pattern):
                kv = PDef((batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim),
                          ("batch", None, "heads", None))
                g[f"{i}:xattn"] = {"k": kv, "v": kv}
        return g

    out = {"blocks": [group(cfg.pattern, bool(cfg.encoder_layers))
                      for _ in range(cfg.n_pattern_groups)]}
    if cfg.n_tail:
        out["tail_blocks"] = [group(cfg.tail_pattern, False)
                              for _ in range(cfg.n_tail)]
    return out


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype=torch.bfloat16, device=None):
    """Zero caches: K/V (and c_kv) in ``dtype``, recurrent states float32."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, list):
            return [walk(g) for g in t]
        return {k: walk(v) if not isinstance(v, PDef) else torch.zeros(
            v.shape, device=dev,
            dtype=dtype if k in _KV_CACHE_KEYS else torch.float32)
            for k, v in t.items()}

    return walk(cache_defs(cfg, batch, seq))


def cache_len(caches) -> Optional[int]:
    """Slots of the self-attention caches (None for an attention-free model)."""
    for gk in ("blocks", "tail_blocks"):
        for g in caches.get(gk, ()):
            for key, c in g.items():
                for name in SEQ_CACHE_KINDS.get(key.split(":", 1)[1], ()):
                    return c[name].shape[1]
    return None


def pad_caches(caches, length: int):
    """The self-attention caches zero-padded along their sequence axis to
    ``length`` slots; picked by block kind and key, never by shape, so the
    encoder's cross-attention caches and the recurrent states stay as
    they are."""
    def group(g):
        out = {}
        for key, c in g.items():
            names = SEQ_CACHE_KINDS.get(key.split(":", 1)[1], ())
            out[key] = {n: (F.pad(t, (0, 0) * (t.dim() - 2)
                                  + (0, length - t.shape[1]))
                            if n in names else t) for n, t in c.items()}
        return out

    return {gk: [group(g) for g in gs] for gk, gs in caches.items()}


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

MIXER_APPLY = {
    "attn": lambda p, h, **kw: attn_apply(p, h, local=False, **kw),
    "attn_local": lambda p, h, **kw: attn_apply(p, h, local=True, **kw),
    "mla": mla_apply,
    "rglru": rglru_apply,
    "mlstm": mlstm_apply,
    "slstm": slstm_apply,
}


def _bidir_attn_apply(p, x, *, cfg, kv=None):
    """Bidirectional (encoder) or cross attention: no mask, no cache."""
    B, S, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = torch_dtype(cfg.compute_dtype)
    xq = x.to(cdt)
    q = (xq @ p["wq"].to(cdt)).reshape(B, S, H, dh)
    src = xq if kv is None else kv.to(cdt)
    T = src.shape[1]
    k = (src @ p["wk"].to(cdt)).reshape(B, T, Hkv, dh)
    v = (src @ p["wv"].to(cdt)).reshape(B, T, Hkv, dh)
    pos_q = torch.arange(S, device=x.device)
    pos_k = torch.arange(T, device=x.device)
    o = blockwise_attention(q, k, v, pos_q, pos_k, causal=False)
    y = o.reshape(B, S, H * dh) @ p["wo"].to(cdt)
    return y.to(x.dtype)


def _xattn_cached(p, x, k_cache, v_cache, *, cfg):
    """Cross-attention against precomputed encoder K/V (decode path)."""
    B, S, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = torch_dtype(cfg.compute_dtype)
    q = (x.to(cdt) @ p["wq"].to(cdt)).reshape(B, S, H, dh)
    qg = q.reshape(B, S, Hkv, H // Hkv, dh)
    s = torch.einsum("bskgd,btkd->bskgt", qg.float(),
                     k_cache.to(cdt).float()) / math.sqrt(dh)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkd->bskgd", pr.to(cdt), v_cache.to(cdt))
    y = o.reshape(B, S, H * dh) @ p["wo"].to(cdt)
    return y.to(x.dtype)


def _xattn_kv(p, enc_out, *, cfg):
    """The cross-attention K/V a decode step reads: the encoder output
    through wk and wv, computed once at prefill."""
    cdt = torch_dtype(cfg.compute_dtype)
    e = enc_out.to(cdt)
    B, T, _ = e.shape
    return {n: (e @ p[w].to(cdt)).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
            for n, w in (("k", "wk"), ("v", "wv"))}


def apply_block(kind: str, p, x, *, cfg, mode, cache, pos):
    """One block: x + mixer(norm1(x)), then x + ffn(norm2(x)).  Returns
    (x, new_cache, aux)."""
    aux = torch.zeros((), device=x.device)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == "attn_bidir":
        y = _bidir_attn_apply(p["mixer"], h, cfg=cfg)
        new_cache = None
    else:
        y, new_cache = MIXER_APPLY[kind](p["mixer"], h, cfg=cfg, mode=mode,
                                         cache=cache, pos=pos)
    x = x + y
    if "ffn" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if cfg.ffn == "moe":
            y, aux = moe_apply(p["ffn"], h, cfg=cfg)
        else:
            y = swiglu_apply(p["ffn"], h, cfg=cfg)
        x = x + y
    return x, new_cache, aux


def _group_step(cfg: ModelConfig, pattern, group: "ParamTree", x, gcache, *,
                mode, pos, enc_out=None):
    """Apply one pattern group: its blocks in pattern order, each followed
    by its cross attention in an encoder-decoder."""
    new_caches = {}
    aux_total = torch.zeros((), device=x.device)
    for i, kind in enumerate(pattern):
        key = f"{i}:{kind}"
        x, nc, aux = getattr(group, key)(
            x, mode=mode, cache=None if gcache is None else gcache.get(key),
            pos=pos)
        aux_total = aux_total + aux
        if cfg.encoder_layers and (enc_out is not None or mode == "decode"):
            xk = f"{i}:xattn"
            xp = getattr(group, xk).tree()
            h = rms_norm(x, xp["norm"], cfg.norm_eps)
            if mode == "decode":
                nc_x = gcache[xk]
                y = _xattn_cached(xp["attn"], h, nc_x["k"], nc_x["v"], cfg=cfg)
            else:
                y = _bidir_attn_apply(xp["attn"], h, cfg=cfg, kv=enc_out)
                nc_x = _xattn_kv(xp["attn"], enc_out, cfg=cfg) \
                    if mode == "prefill" else None
            x = x + y
            if nc_x is not None:
                new_caches[xk] = nc_x
        if nc is not None:
            new_caches[key] = nc
    return x, (new_caches or None), aux_total


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """Parameters of a nested dict/list tree as modules: a dict becomes a
    module whose tensors are parameters and whose dicts are submodules, a
    list a ``ModuleList``.  :meth:`tree` returns the nested dict of the
    parameters themselves (no copy)."""

    def __init__(self, tree: Dict[str, Any], make_child=None):
        super().__init__()
        make_child = make_child or (lambda key, t: ParamTree(t))
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, make_child(k, v))
            elif isinstance(v, list):
                self.add_module(k, nn.ModuleList(make_child(k, g) for g in v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self._parameters)
        for k, m in self._modules.items():
            out[k] = [g.tree() for g in m] if isinstance(m, nn.ModuleList) \
                else m.tree()
        return out


class Block(ParamTree):
    """One layer of kind ``kind`` (attn, attn_local, attn_bidir, mla, rglru,
    mlstm, slstm): norm1 and its mixer, then norm2 and its FFN (SwiGLU or
    MoE) where the config has one."""

    def __init__(self, cfg: ModelConfig, kind: str, tree: Dict[str, Any]):
        super().__init__(tree)
        self.cfg, self.kind = cfg, kind

    def forward(self, x, *, mode, cache=None, pos=None):
        return apply_block(self.kind, self.tree(), x, cfg=self.cfg, mode=mode,
                           cache=cache, pos=pos)


def _group_module(cfg: ModelConfig, key: str, tree: Dict[str, Any]) -> ParamTree:
    """A pattern group: one Block per ``"{i}:{kind}"`` entry, the cross
    attention's parameters under ``"{i}:xattn"``."""
    def child(k, t):
        kind = k.split(":", 1)[1]
        return ParamTree(t) if kind == "xattn" else Block(cfg, kind, t)
    return ParamTree(tree, child)


def _tensor(a) -> torch.Tensor:
    """``a`` as a tensor: a tensor as it is, an array copied (JAX hands out
    read-only buffers)."""
    return a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))


def _check_layout(defs, tree, path="params"):
    if isinstance(defs, PDef):
        if tuple(tree.shape) != tuple(defs.shape):
            raise ValueError(f"{path}: shape {tuple(tree.shape)}, the config "
                             f"needs {tuple(defs.shape)}")
        return
    if isinstance(defs, list):
        if not isinstance(tree, list) or len(tree) != len(defs):
            raise ValueError(f"{path}: {len(defs)} groups expected")
        for i, (d, t) in enumerate(zip(defs, tree)):
            _check_layout(d, t, f"{path}[{i}]")
        return
    if not isinstance(tree, dict) or set(tree) != set(defs):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path}: keys {got}, the config needs {sorted(defs)}")
    for k in defs:
        _check_layout(defs[k], tree[k], f"{path}.{k}")


class Model(ParamTree):
    """A decoder (+ encoder) of the config's block kinds, serving prefill
    and cached greedy decode.

    Build it with :meth:`init` (weights drawn from a seeded generator) or
    :meth:`from_params` (a parameter tree of numpy arrays or tensors, such
    as :func:`repro_torch.convert.lm_params_from_jax` returns).
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        _check_layout(model_defs(cfg), params)
        super().__init__(params, lambda k, t: _group_module(cfg, k, t))
        self.cfg = cfg

    @classmethod
    def init(cls, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
             device=None) -> "Model":
        """Weights from :func:`init_from_defs` in ``cfg.param_dtype``, drawn
        from ``gen`` (default: seed 0 on the device)."""
        dev = resolve_device(device if device is not None or gen is None
                             else gen.device)
        if gen is None:
            gen = torch.Generator(dev).manual_seed(0)
        return cls(cfg, init_from_defs(model_defs(cfg), gen,
                                       torch_dtype(cfg.param_dtype), dev))

    @classmethod
    def from_params(cls, cfg: ModelConfig, params: Dict[str, Any],
                    device=None) -> "Model":
        """A model over ``params`` moved to the device; tensors already
        there are shared, not copied."""
        dev = resolve_device(device)
        return cls(cfg, tree_map(lambda a: _tensor(a).to(dev), params))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # -- embedding / head ----------------------------------------------------
    def token_embeds(self, tokens) -> torch.Tensor:
        """The decode step's input embedding of ``tokens``: the embedding
        table scaled by √d, or for a frontend stub lm_headᵀ scaled by √d
        (what a teacher-forced prompt of such a model extends with)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        table = self.embed if self.cfg.frontend == "none" else self.lm_head.t()
        return table[tokens] * math.sqrt(self.cfg.d_model)

    def _embed(self, batch) -> torch.Tensor:
        cfg = self.cfg
        if cfg.frontend == "none":
            x = self.token_embeds(batch["tokens"])
        else:
            x = torch.as_tensor(batch["embeds"], device=self.device)
        return x.to(torch_dtype(cfg.compute_dtype))

    def _encode(self, batch) -> torch.Tensor:
        cfg = self.cfg
        x = torch.as_tensor(batch["enc_embeds"], device=self.device).to(
            torch_dtype(cfg.compute_dtype))
        for group in self.encoder_blocks:
            x, _, _ = _group_step(cfg, ("attn_bidir",), group, x, None,
                                  mode="train", pos=None)
        return rms_norm(x, self.encoder_norm, cfg.norm_eps)

    def _trunk(self, x, caches, *, mode, pos, enc_out):
        cfg = self.cfg
        collect = mode in ("prefill", "decode")
        new_caches: Dict[str, Any] = {}
        aux = torch.zeros((), device=x.device)
        for gk, pattern in (("blocks", cfg.pattern),
                            ("tail_blocks", cfg.tail_pattern)):
            if not hasattr(self, gk):
                continue
            out = []
            for g, group in enumerate(getattr(self, gk)):
                gcache = None if caches is None else caches[gk][g]
                x, nc, a = _group_step(cfg, pattern, group, x, gcache,
                                       mode=mode, pos=pos,
                                       enc_out=enc_out if gk == "blocks" else None)
                aux = aux + a
                out.append(nc)
            if collect:
                new_caches[gk] = out
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return x, (new_caches if collect else None), aux

    def _logits(self, x) -> torch.Tensor:
        return x @ self.lm_head.to(x.dtype)

    # -- entry points --------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, batch, cache_len: Optional[int] = None):
        """Run the prompt; returns (last-position logits (B, 1, V), caches).

        ``batch`` holds ``tokens`` (B, S) (``embeds`` (B, S, d) for a
        frontend stub) and, for an encoder-decoder, ``enc_embeds``.  With
        ``cache_len`` the self-attention caches are padded to that many
        slots, room for ``cache_len - S`` decode steps.
        """
        cfg = self.cfg
        enc_out = self._encode(batch) if cfg.encoder_layers else None
        x = self._embed(batch)
        S = x.shape[1]
        x, caches, _ = self._trunk(x, None, mode="prefill", pos=None,
                                   enc_out=enc_out)
        logits = self._logits(x[:, -1:, :])
        if cache_len is not None:
            if cache_len < S:
                raise ValueError(f"cache_len {cache_len} < prompt length {S}")
            caches = pad_caches(caches, cache_len)
        return logits, caches

    @torch.inference_mode()
    def decode_step(self, tokens, caches, pos: int):
        """One token for the whole batch at position ``pos``: tokens (B, 1).
        Writes the step's K/V into the caches in place and returns (logits
        (B, 1, V), caches).  Raises when ``pos`` is past the caches."""
        pos = int(pos)
        slots = cache_len(caches)
        if pos < 0 or (slots is not None and pos >= slots):
            raise ValueError(f"decode position {pos} outside the caches' "
                             f"{slots} slots; prefill with a larger cache_len")
        x = self.token_embeds(tokens).to(torch_dtype(self.cfg.compute_dtype))
        x, new_caches, _ = self._trunk(x, caches, mode="decode", pos=pos,
                                       enc_out=None)
        return self._logits(x), new_caches
