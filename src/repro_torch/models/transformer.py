"""Model assembly: the decoder over every block kind (+ an optional encoder),
its caches, and the training loss, prefill and decode entry points: the
port of ``repro.models.transformer``.

Layers come in pattern groups (``cfg.pattern`` repeated ``n_pattern_groups``
times, plus an optional tail) as in the reference, but unstacked: the
parameter and cache trees hold one dict per group in a list (``blocks``,
``tail_blocks``, ``encoder_blocks``), keyed inside a group by
``"{i}:{kind}"`` (and ``"{i}:xattn"`` for an encoder-decoder's cross
attention), and a Python loop over groups replaces ``jax.lax.scan``.

:class:`Model` holds the parameters as modules (one :class:`Block` per
layer) and runs on CUDA unless given ``device="cpu"``.  The parameters are
registered without gradients; training switches them on
(``repro_torch.train.make_train_step``), while ``prefill`` and
``decode_step`` run under ``torch.inference_mode``.  Remat wraps each layer
group in ``torch.utils.checkpoint`` as ``jax.checkpoint`` wraps the
reference's scan body, with the policy :func:`set_remat_policy` picks.  Two
behaviours differ from the reference on purpose:

* ``prefill(batch, cache_len)`` pads the self-attention caches (``k``,
  ``v`` of ``attn``/``attn_local``, ``c_kv`` of ``mla``) to ``cache_len``
  along their sequence axis, picked by key and block kind.  The reference
  pads by shape (``leaf.shape[1] == S``), which its group-stacked caches
  never match, so its decode steps overwrite the last prompt slot.
* ``decode_step`` raises when ``pos`` is past the cache instead of
  clamping the write.

On a mesh (``Model.init(..., mesh=)`` / ``from_params(..., mesh=)``, a
``DeviceMesh`` from :mod:`repro_torch.launch.mesh`) each parameter is a
DTensor placed by its ``PDef`` axes under the rules of
:mod:`repro_torch.models.sharding`, and ``prefill``/``decode_step`` run
inside ``sharding_rules(mesh)``: the tokens enter as the residual stream
placed by the batch rule (``("batch", "seq", "dmodel")``), each block's
mixer and FFN run as regions over local shards with explicit collectives
(each mixer on its ``model`` shard of the projections, moving activations
rather than weights), the caches leave placed by :func:`cache_axes` (K/V split over ``model``
along ``kv_seq``), and the logits leave through ``full_tensor()``.  The
batch must split evenly over the batch axes.  ``loss_fn`` runs there too:
each region's inputs take their gradients' placements
(:func:`~repro_torch.models.sharding.grad_placements`), its collectives
carry their conjugate backward, and the cross entropy is
vocabulary-parallel (:meth:`Model._nll_on_mesh`), so the parameters'
gradients come out as DTensors and equal the no-mesh ones.
"""
from __future__ import annotations

import contextlib
import math
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.kron_matvec._layout import resolve_device

from .config import ModelConfig, torch_dtype
from .layers import (KV_CACHE_AXES, MLA_CACHE_AXES, XATTN_CACHE_AXES, PDef,
                     attn_apply, attn_defs, axes_from_defs, bidir_attn_mesh,
                     blockwise_attention, init_from_defs, is_pdef, mla_apply,
                     mla_defs, rms_norm, swiglu_apply, swiglu_defs,
                     tree_leaves, tree_map, xattn_decode_mesh)
from .moe import moe_apply, moe_defs
from .recurrent import (RNN_CACHE_AXES, mlstm_apply, mlstm_defs,
                        rglru_apply, rglru_defs, slstm_apply, slstm_defs)
from .sharding import (ACT, all_reduce, axes_bounds, batch_axis_names,
                       batch_rows, current_mesh, current_rules, distribute,
                       from_local, is_dtensor, logical, param_spec, region,
                       require_group, rule_axes, sharding_rules, to_local)

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
        shapes = {"k": (batch, seq, Hkv, dh), "v": (batch, seq, Hkv, dh)}
        axes = KV_CACHE_AXES
    elif kind == "mla":
        shapes, axes = {"c_kv": (batch, seq, cfg.kv_lora_rank)}, MLA_CACHE_AXES
    elif kind == "rglru":
        shapes = {"h": (batch, cfg.rnn_state_dim or cfg.d_model)}
        axes = RNN_CACHE_AXES[kind]
    elif kind == "mlstm":
        shapes = {"C": (batch, H, dh, dh), "n": (batch, H, dh), "m": (batch, H)}
        axes = RNN_CACHE_AXES[kind]
    elif kind == "slstm":
        shapes = {k: (batch, H, dh) for k in ("c", "n", "m", "h")}
        axes = RNN_CACHE_AXES[kind]
    else:
        raise ValueError(kind)
    return {k: PDef(v, axes[k]) for k, v in shapes.items()}


def cache_defs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    def group(pattern, xattn):
        g = {f"{i}:{kind}": _mixer_cache_defs(cfg, kind, batch, seq)
             for i, kind in enumerate(pattern)}
        if xattn:  # decode-time cross-attn K/V from the encoder
            for i, _ in enumerate(pattern):
                shape = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
                g[f"{i}:xattn"] = {k: PDef(shape, a)
                                   for k, a in XATTN_CACHE_AXES.items()}
        return g

    out = {"blocks": [group(cfg.pattern, bool(cfg.encoder_layers))
                      for _ in range(cfg.n_pattern_groups)]}
    if cfg.n_tail:
        out["tail_blocks"] = [group(cfg.tail_pattern, False)
                              for _ in range(cfg.n_tail)]
    return out


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype=torch.bfloat16, device=None, mesh=None):
    """Zero caches: K/V (and c_kv) in ``dtype``, recurrent states float32;
    on ``mesh`` each placed by its :func:`cache_axes`."""
    dev = resolve_device(device if mesh is None else mesh.device_type)

    def make(k, pd):
        z = torch.zeros(pd.shape, device=dev,
                        dtype=dtype if k in _KV_CACHE_KEYS else torch.float32)
        return z if mesh is None else distribute(
            z, param_spec(mesh, pd.axes))

    def walk(t):
        if isinstance(t, list):
            return [walk(g) for g in t]
        return {k: make(k, v) if is_pdef(v) else walk(v)
                for k, v in t.items()}

    return walk(cache_defs(cfg, batch, seq))


def cache_axes(cfg: ModelConfig, batch: int, seq: int):
    return axes_from_defs(cache_defs(cfg, batch, seq))


def place_caches(caches, cfg: ModelConfig):
    """Each cache leaf redistributed to its :func:`cache_axes` under the
    active rules (the self-attention K/V split over ``model`` along
    ``kv_seq``); outside a mesh context the caches as they are."""
    B = next(iter(tree_leaves(caches))).shape[0]
    axes = cache_axes(cfg, B, cache_len(caches) or 1)
    return tree_map(lambda t, a: logical(t, *a), caches, axes)


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
    def pad(t):
        widths = (0, 0) * (t.dim() - 2) + (0, length - t.shape[1])
        if not is_dtensor(t):
            return F.pad(t, widths)
        # a gathered prefill cache: its sequence axis is whole on each rank
        return from_local(F.pad(t.to_local(), widths), t.device_mesh,
                          ("batch",) + (None,) * (t.dim() - 1),
                          (t.shape[0], length) + tuple(t.shape[2:]))

    def group(g):
        out = {}
        for key, c in g.items():
            names = SEQ_CACHE_KINDS.get(key.split(":", 1)[1], ())
            out[key] = {n: (pad(t) if n in names else t)
                        for n, t in c.items()}
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


def _bidir_attn_apply(p, x, *, cfg, kv=None, mode="train"):
    """Bidirectional (encoder) or cross attention: no mask.  On DTensors a
    region over each rank's ``qkv`` shard of the projections
    (:func:`~repro_torch.models.layers.bidir_attn_mesh`); a cross
    attention's prefill there also returns its K/V, the decode steps'
    cache."""
    if is_dtensor(x):
        y, kv_cache = bidir_attn_mesh(p, x, cfg=cfg, kv=kv,
                                      keep_kv=mode == "prefill")
        return y if kv is None else (y, kv_cache)
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
    if kv is None:
        return y.to(x.dtype)
    return y.to(x.dtype), (_xattn_kv(p, kv, cfg=cfg) if mode == "prefill"
                           else None)


def _xattn_cached(p, x, k_cache, v_cache, *, cfg):
    """Cross-attention against precomputed encoder K/V (decode path).  On
    DTensors a region (:func:`~repro_torch.models.layers.xattn_decode_mesh`)."""
    if is_dtensor(x):
        return xattn_decode_mesh(p, x, k_cache, v_cache, cfg=cfg)
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
    through wk and wv, computed once at prefill (off a mesh; on one the
    prefill's cross attention returns them,
    :func:`~repro_torch.models.layers.bidir_attn_mesh`)."""
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
            if is_dtensor(aux):             # replicated: its value on every rank
                aux = aux.to_local()
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
                y, nc_x = _bidir_attn_apply(xp["attn"], h, cfg=cfg,
                                            kv=enc_out, mode=mode)
            x = x + y
            if nc_x is not None:
                new_caches[xk] = nc_x
        if nc is not None:
            new_caches[key] = nc
    return x, (new_caches or None), aux_total


# Remat policies: what a layer group keeps for its backward pass; the rest
# is recomputed.  "dots" keeps the outputs of the un-batched matrix products
# (``x @ W`` reaches ``aten.mm``; the attention einsums reach ``aten.bmm``),
# as ``dots_with_no_batch_dims_saveable`` does.  "dots+kv" also keeps the
# K/V the reference names "kv" for its all-gather; on one device those are
# reshaped ``mm`` outputs already, so it keeps what "dots" keeps.  "nothing"
# keeps only the group's inputs.
_SAVE_MM = partial(create_selective_checkpoint_contexts,
                   [torch.ops.aten.mm.default])
_REMAT_POLICIES = {"dots": _SAVE_MM, "dots+kv": _SAVE_MM, "nothing": None}
_ACTIVE_REMAT_POLICY = ["dots"]


def set_remat_policy(name: str):
    assert name in _REMAT_POLICIES, name
    _ACTIVE_REMAT_POLICY[0] = name


def _remat_group(cfg: ModelConfig, pattern, group: "ParamTree", x, enc_out):
    """One layer group of a training forward under ``torch.utils.checkpoint``
    with the active policy.  Returns (x, aux).  The recomputation runs in
    the backward pass, outside the caller's mesh context (and, on CUDA, in
    autograd's own thread), so it enters the context the forward ran in:
    every rank then issues the same collectives in the same order."""
    mesh, rules = current_mesh(), current_rules()

    def run(x, enc_out):
        with sharding_rules(mesh, rules):
            x, _, aux = _group_step(cfg, pattern, group, x, None,
                                    mode="train", pos=None, enc_out=enc_out)
        return x, aux

    context_fn = _REMAT_POLICIES[_ACTIVE_REMAT_POLICY[0]]
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(run, x, enc_out, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

_NO_CONTEXT = contextlib.nullcontext()


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
    if is_pdef(defs):
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
    """A decoder (+ encoder) of the config's block kinds: its training
    loss, prefill and cached greedy decode.

    Build it with :meth:`init` (weights drawn from a seeded generator) or
    :meth:`from_params` (a parameter tree of numpy arrays or tensors, such
    as :func:`repro_torch.convert.lm_params_from_jax` returns).
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], mesh=None):
        _check_layout(model_defs(cfg), params)
        super().__init__(params, lambda k, t: _group_module(cfg, k, t))
        self.cfg, self.mesh = cfg, mesh

    @classmethod
    def init(cls, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
             device=None, mesh=None) -> "Model":
        """Weights from :func:`init_from_defs` in ``cfg.param_dtype``, drawn
        from ``gen`` (default: seed 0 on the device).  On ``mesh`` every
        rank draws the same values and keeps its shard of each leaf, placed
        by the leaf's ``PDef`` axes, before the next leaf is drawn; the
        weights equal the ones drawn without a mesh."""
        if mesh is not None:
            require_group()
            device = mesh.device_type
        dev = resolve_device(device if device is not None or gen is None
                             else gen.device)
        if gen is None:
            gen = torch.Generator(dev).manual_seed(0)
        place = None if mesh is None else (
            lambda pd, t: distribute(t, param_spec(mesh, pd.axes)))
        return cls(cfg, init_from_defs(model_defs(cfg), gen,
                                       torch_dtype(cfg.param_dtype), dev,
                                       place=place), mesh)

    @classmethod
    def from_params(cls, cfg: ModelConfig, params: Dict[str, Any],
                    device=None, mesh=None) -> "Model":
        """A model over ``params`` moved to the device; tensors already
        there are shared, not copied.  On ``mesh`` each leaf is placed by
        its ``PDef`` axes (a DTensor leaf is kept as it is)."""
        if mesh is None:
            dev = resolve_device(device)
            return cls(cfg, tree_map(lambda a: _tensor(a).to(dev), params))
        require_group()
        dev = resolve_device(mesh.device_type)
        return cls(cfg, tree_map(
            lambda a, pd: a if is_dtensor(a) else distribute(
                _tensor(a).to(dev), param_spec(mesh, pd.axes)),
            params, model_defs(cfg)), mesh)

    def param_defs(self):
        """The parameter tree's PDef leaves (:func:`model_defs`)."""
        return model_defs(self.cfg)

    def param_axes(self):
        """The logical axes of every parameter, in the parameter tree's
        structure."""
        return axes_from_defs(self.param_defs())

    def _rules(self):
        """The mesh context this model runs in (none without a mesh): the
        caller's, when one is active (its rules, or DP-SGD's example mesh,
        :func:`repro_torch.train.dp.example_mesh`), else the model's mesh
        under the default rules."""
        if self.mesh is None or current_mesh() is not None:
            return _NO_CONTEXT
        return sharding_rules(self.mesh)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # -- embedding / head ----------------------------------------------------
    def token_embeds(self, tokens) -> torch.Tensor:
        """The decode step's input embedding of ``tokens``: the embedding
        table scaled by √d, or for a frontend stub lm_headᵀ scaled by √d
        (what a teacher-forced prompt of such a model extends with).  On a
        mesh, a region: each rank looks up the tokens in its shard of the
        vocabulary (split over the ``vocab`` rule's axes) and the rows are
        added over those axes."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        stub = self.cfg.frontend != "none"
        if self.mesh is not None:
            with self._rules():
                return self._embeds_on_mesh(tokens, stub)
        table = self.lm_head.t() if stub else self.embed
        return table[tokens] * math.sqrt(self.cfg.d_model)

    def _embeds_on_mesh(self, tokens, stub: bool):
        mesh, V = current_mesh(), self.cfg.vocab_size
        B = tokens.shape[0]

        vocab = rule_axes("vocab", mesh)

        def body(table):
            table = table.t() if stub else table
            lo, hi = axes_bounds(V, mesh, vocab)
            b0, b1 = batch_rows(mesh, B)
            t = tokens[b0:b1]
            inside = (t >= lo) & (t < hi)
            if hi > lo:
                rows = table[(t - lo).clamp(0, hi - lo - 1)]
            else:
                rows = table.new_zeros(t.shape + (table.shape[1],))
            rows = rows * inside[..., None].to(rows.dtype)
            return all_reduce(rows, mesh, vocab) * math.sqrt(self.cfg.d_model)

        table = self.lm_head if stub else self.embed
        names = (None, "vocab") if stub else ("vocab", None)
        return region(body, (table,), (names,), (ACT,), split=vocab)

    def _host_rows(self, a):
        """Input rows for this model: on a mesh, this rank's batch rows as
        the residual stream's DTensor."""
        a = torch.as_tensor(a, device=self.device)
        if self.mesh is None:
            return a
        mesh = current_mesh()
        b0, b1 = batch_rows(mesh, a.shape[0])
        return from_local(a[b0:b1], mesh,
                          ("batch",) + (None,) * (a.dim() - 1), a.shape)

    def _embed(self, batch) -> torch.Tensor:
        cfg = self.cfg
        if cfg.frontend == "none":
            x = self.token_embeds(batch["tokens"])
        else:
            x = self._host_rows(batch["embeds"])
        return logical(x.to(torch_dtype(cfg.compute_dtype)), *ACT)

    def _encode(self, batch) -> torch.Tensor:
        cfg = self.cfg
        x = self._host_rows(batch["enc_embeds"]).to(
            torch_dtype(cfg.compute_dtype))
        for group in self.encoder_blocks:
            x, _, _ = _group_step(cfg, ("attn_bidir",), group, x, None,
                                  mode="train", pos=None)
        return rms_norm(x, self.encoder_norm, cfg.norm_eps)

    def _trunk(self, x, caches, *, mode, pos, enc_out, remat=False):
        cfg = self.cfg
        collect = mode in ("prefill", "decode")
        new_caches: Dict[str, Any] = {}
        aux = torch.zeros((), device=x.device)
        for gk, pattern in (("blocks", cfg.pattern),
                            ("tail_blocks", cfg.tail_pattern)):
            if not hasattr(self, gk):
                continue
            out = []
            enc = enc_out if gk == "blocks" else None
            for g, group in enumerate(getattr(self, gk)):
                if remat:
                    (x, a), nc = _remat_group(cfg, pattern, group, x, enc), None
                else:
                    gcache = None if caches is None else caches[gk][g]
                    x, nc, a = _group_step(cfg, pattern, group, x, gcache,
                                           mode=mode, pos=pos, enc_out=enc)
                aux = aux + a
                out.append(nc)
            if collect:
                new_caches[gk] = out
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return x, (new_caches if collect else None), aux

    def _logits(self, x) -> torch.Tensor:
        if not is_dtensor(x):
            return x @ self.lm_head.to(x.dtype)
        # this rank's vocabulary columns, placed ("batch", "seq", "vocab")
        y = x.to_local() @ to_local(self.lm_head, None, "vocab").to(x.dtype)
        return from_local(y, current_mesh(), ("batch", "seq", "vocab"),
                          tuple(x.shape[:2]) + (self.cfg.vocab_size,))

    # -- entry points --------------------------------------------------------
    def loss_fn(self, batch, *, remat: bool = True,
                aux_weight: float = 0.01) -> torch.Tensor:
        """Mean next-token cross entropy in float32 over the positions whose
        ``labels`` (already shifted) are >= 0, plus ``aux_weight`` times the
        MoE routers' load-balancing loss.  ``batch`` holds what
        :meth:`prefill` takes and ``labels`` (B, S); with ``remat`` each
        layer group is recomputed in the backward pass under the active
        remat policy.  On a mesh every rank passes the same whole batch and
        keeps its own rows; the loss, a plain 0-d tensor, is the whole
        batch's on every rank."""
        cfg = self.cfg
        with self._rules():
            enc_out = self._encode(batch) if cfg.encoder_layers else None
            x = self._embed(batch)
            x, _, aux = self._trunk(x, None, mode="train", pos=None,
                                    enc_out=enc_out, remat=remat)
            labels = torch.as_tensor(batch["labels"], device=self.device).long()
            if self.mesh is not None:
                return self._nll_on_mesh(x, labels) + aux_weight * aux
            logits = self._logits(x).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
            mask = (labels >= 0).float()
            nll = torch.sum((lse - gold) * mask) / mask.sum().clamp_min(1.0)
            return nll + aux_weight * aux

    def _nll_on_mesh(self, x, labels) -> torch.Tensor:
        """The masked mean cross entropy, vocabulary-parallel: a region in
        which each rank holds its vocabulary columns of the logits (split
        over the ``vocab`` rule's axes) for its batch rows; the max (no
        gradient), the sum of exponentials and the gold logit are reduced
        over the vocabulary's axes, the nll sum and the mask count over the
        batch axes."""
        mesh, V = current_mesh(), self.cfg.vocab_size
        vocab = rule_axes("vocab", mesh)
        lo, hi = axes_bounds(V, mesh, vocab)
        if hi == lo:
            raise ValueError(f"a vocabulary of {V} leaves a model rank none")
        b0, b1 = batch_rows(mesh, labels.shape[0])
        lab = labels[b0:b1]

        def body(x, w):
            logits = (x @ w.to(x.dtype)).float()          # (b, S, hi - lo)
            with torch.no_grad():
                m = all_reduce(logits.amax(dim=-1), mesh, vocab,
                               op=dist.ReduceOp.MAX)
            sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
            lse = m + torch.log(all_reduce(sumexp, mesh, vocab))
            gold = logits.gather(-1, (lab - lo).clamp(0, hi - lo - 1)
                                 [..., None])[..., 0]
            inside = (lab >= lo) & (lab < hi)
            gold = all_reduce(torch.where(inside, gold, 0.0), mesh, vocab)
            mask = (lab >= 0).float()
            nll = torch.sum((lse - gold) * mask).reshape(1)
            count = mask.sum().reshape(1)
            nll = all_reduce(nll, mesh, batch_axis_names(mesh))
            count = all_reduce(count, mesh, batch_axis_names(mesh))
            return (nll / count.clamp_min(1.0)).reshape(())

        return region(body, (x, self.lm_head), (ACT, (None, "vocab")),
                      ((),), split=vocab).to_local()

    def forward(self, batch, aux_weight: float = 0.01):
        """The training loss without remat, :meth:`loss_fn`: what
        ``torch.func.functional_call`` calls, and ``torch.func.grad``
        refuses the saved-tensor hooks that remat works through."""
        return self.loss_fn(batch, remat=False, aux_weight=aux_weight)

    @torch.inference_mode()
    def prefill(self, batch, cache_len: Optional[int] = None):
        """Run the prompt; returns (last-position logits (B, 1, V), caches).

        ``batch`` holds ``tokens`` (B, S) (``embeds`` (B, S, d) for a
        frontend stub) and, for an encoder-decoder, ``enc_embeds``.  With
        ``cache_len`` the self-attention caches are padded to that many
        slots, room for ``cache_len - S`` decode steps.
        """
        with self._rules():
            cfg = self.cfg
            enc_out = self._encode(batch) if cfg.encoder_layers else None
            x = self._embed(batch)
            S = x.shape[1]
            x, caches, _ = self._trunk(x, None, mode="prefill", pos=None,
                                       enc_out=enc_out)
            logits = self._logits(x[:, -1:, :])
            if cache_len is not None:
                if cache_len < S:
                    raise ValueError(f"cache_len {cache_len} < prompt "
                                     f"length {S}")
                caches = pad_caches(caches, cache_len)
            if self.mesh is None:
                return logits, caches
            return logits.full_tensor(), place_caches(caches, cfg)

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
        with self._rules():
            x = self.token_embeds(tokens).to(
                torch_dtype(self.cfg.compute_dtype))
            x, new_caches, _ = self._trunk(x, caches, mode="decode", pos=pos,
                                           enc_out=None)
            logits = self._logits(x)
            if self.mesh is None:
                return logits, new_caches
            return logits.full_tensor(), new_caches
