"""Recurrent mixers: RG-LRU (RecurrentGemma/Griffin), mLSTM and sLSTM
(xLSTM): the port of ``repro.models.recurrent``.

Prefill runs mLSTM chunkwise-parallel over the sequence.  RG-LRU loops over
it with the decode step's own recurrence in float32, in place of the
reference's associative scan, so that a prefill row and a decode step
round alike (a log-depth scan rounds differently, and at bf16 compute
that difference grows through the layers: PERF.md, PR 21).  sLSTM feeds
its hidden state back into the gates and loops too.  Both loops run through
:func:`repro_torch.models.loops.token_loop`, which the dry run counts from
a few steps.  Decode is one recurrent step with O(1) state.

On a mesh each mixer runs as a region over this rank's batch rows
(:func:`repro_torch.models.sharding.mixer_region`) with its projections
split over ``model`` as the reference's rules place its weights (XLA
splits the work from them):

* RG-LRU: each rank holds its ``rnn_state`` channels of ``w_in``,
  ``w_gate``, both gate weights and ``lam`` and its rows of ``w_out``.
  The gates contract ``u`` over the whole state, so ``u`` is gathered (one
  (B, S, w) activation; the other way round, an all-reduce of both
  gates' partial sums, needs the gate weights' rows and moves at least
  twice the bytes); the
  recurrence is elementwise per channel and runs on this rank's channels
  against its slice of ``h`` (``RNN_CACHE_AXES``); the output's partial
  sums are added over ``model``.
* mLSTM and sLSTM: each rank holds its ``qkv`` columns of the input
  projections and its rows of ``wo``; ``w_if``, ``b_if``, ``r_h`` and
  ``b`` stay whole, and each rank uses their columns of its heads.  Where
  the heads divide the axis a rank's columns are whole heads and nothing
  moves before the per-head math; where they do not (xLSTM-350M's 4
  heads on a 16-way axis) the flattened columns are exchanged into the
  whole heads they touch.  The mLSTM then splits each
  head's value columns (its memory C by columns, the key side whole);
  the sLSTM, whose hidden state feeds all four gates of its head, runs a
  head on every rank that touches it.  The states leave whole, as their
  cache axes place them.

In training the gradients of ``x`` and of the whole weights leave the
region partial over ``model`` (each rank's columns contribute), the split
weights' as their shards.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .config import torch_dtype
from .layers import PDef
from .loops import token_loop
from .sharding import (all_reduce, axis_rank, exchange, is_dtensor,
                       mixer_region, one_axis, rank_chunks)

RNN_CACHE_AXES = {
    "rglru": {"h": ("batch", "rnn_state")},
    "mlstm": {"C": ("batch", "heads", None, None), "n": ("batch", "heads", None),
              "m": ("batch", "heads")},
    "slstm": {k: ("batch", "heads", None) for k in ("c", "n", "m", "h")},
}


def _head_spans(cols, width: int) -> List[Tuple[int, int]]:
    """The heads [h0, h1) each rank's columns ``cols`` of a flattened
    (heads, ``width``) dim touch."""
    return [(c0 // width, -(-c1 // width) if c1 > c0 else c0 // width)
            for c0, c1 in cols]


def _owners(spans) -> List[Tuple[int, int]]:
    """A partition of the heads: each head to the first rank whose span
    holds it (the ranks that touch a head compute its states alike)."""
    out, prev = [], 0
    for h0, h1 in spans:
        lo = max(h0, prev)
        out.append((lo, max(lo, h1)))
        prev = out[-1][1]
    return out


def _gather_heads(t, spans, me, mesh, axis):
    """A state (B, heads of this rank's span, ...) whole over the heads on
    every rank: each head from its owner (:func:`_owners`)."""
    own = _owners(spans)
    lo, hi = own[me]
    t = t[:, lo - spans[me][0]:hi - spans[me][0]]
    return exchange(t, mesh, axis, 1, own, 1, [(0, own[-1][1])] * len(own))


# ---------------------------------------------------------------------------
# RG-LRU (Griffin): h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


def rglru_defs(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    w = cfg.rnn_state_dim or d
    return {
        "w_in": PDef((d, w), ("dmodel_fsdp", "rnn_state")),
        "w_gate": PDef((d, w), ("dmodel_fsdp", "rnn_state")),
        "w_rec_gate": PDef((d, w), ("dmodel_fsdp", "rnn_state")),
        "w_inp_gate": PDef((d, w), ("dmodel_fsdp", "rnn_state")),
        "lam": PDef((w,), ("rnn_state",), init="ones"),
        "w_out": PDef((w, d), ("rnn_state", "dmodel_fsdp")),
    }


RGLRU_REGION_AXES = dict(
    {k: (None, "rnn_state") for k in ("w_in", "w_gate", "w_rec_gate",
                                     "w_inp_gate")},
    lam=("rnn_state",), w_out=("rnn_state", None))


def _rglru_coeffs(p, u_all, u, cdt):
    """Per-step (a_t, b_t) of the linear recurrence h = a⊙h_prev + b, on
    the channels of ``u``; the gates contract the whole state ``u_all``."""
    r = torch.sigmoid((u_all @ p["w_rec_gate"].to(cdt)).float())
    i = torch.sigmoid((u_all @ p["w_inp_gate"].to(cdt)).float())
    log_a = -RGLRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated = i * u.float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * gated
    return a, b


def _rglru_step(carry, x_t, consts):
    a_t, b_t = x_t
    h = a_t * carry[0] + b_t
    return (h,), h


def rglru_apply(p, x, *, cfg, mode: str, cache=None, pos=None, mesh=None):
    """x: (B, S, D) → (y, new_cache);  cache = {'h': (B, w)} float32.  On
    a mesh, this rank's ``rnn_state`` channels (module docstring)."""
    if is_dtensor(x):
        return mixer_region(rglru_apply, p, x, axes=RGLRU_REGION_AXES,
                            cache=cache, cache_axes=RNN_CACHE_AXES["rglru"],
                            stored={"h": (cfg.rnn_state_dim or cfg.d_model,)},
                            split=one_axis("rnn_state"), cfg=cfg, mode=mode,
                            pos=pos)
    B, S, D = x.shape
    cdt = torch_dtype(cfg.compute_dtype)
    xq = x.to(cdt)
    u = xq @ p["w_in"].to(cdt)                           # (B, S, w)
    gate = F.gelu(xq @ p["w_gate"].to(cdt), approximate="tanh")
    u_all = u
    if mesh is not None:
        axis = one_axis("rnn_state", mesh)
        cols = rank_chunks(cfg.rnn_state_dim or cfg.d_model, mesh, axis)
        u_all = exchange(u, mesh, axis, -1, cols, -1,
                         [(0, cols[-1][1])] * len(cols))
    a, b = _rglru_coeffs(p, u_all, u, cdt)               # float32 (B, S, w)

    if mode == "decode":
        h = a[:, 0] * cache["h"] + b[:, 0]
        hs = h[:, None]
        new_cache = {"h": h}
    else:
        # the decode step's recurrence, step by step: each prefill row is
        # rounded exactly as a decode step would round it
        h = torch.zeros_like(a[:, 0]) if cache is None else cache["h"]
        (h,), hs = token_loop(_rglru_step, (h,), (a, b), S)   # (B, S, w)
        new_cache = {"h": h} if mode == "prefill" else None
    y = (hs.to(cdt) * gate) @ p["w_out"].to(cdt)
    if mesh is not None:
        y = all_reduce(y, mesh, axis)
    return y.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): matrix memory  C_t = f_t C_{t-1} + i_t v_t k_tᵀ
# ---------------------------------------------------------------------------

def mlstm_defs(cfg) -> Dict[str, Any]:
    d, qd = cfg.d_model, cfg.q_dim
    H = cfg.n_heads
    return {
        "wq": PDef((d, qd), ("dmodel_fsdp", "qkv")),
        "wk": PDef((d, qd), ("dmodel_fsdp", "qkv")),
        "wv": PDef((d, qd), ("dmodel_fsdp", "qkv")),
        "w_if": PDef((d, 2 * H), ("dmodel_fsdp", None)),
        "b_if": PDef((2 * H,), (None,), init="zeros"),
        "wo": PDef((qd, d), ("qkv", "dmodel_fsdp")),
    }


def _mlstm_chunk(q, k, v, ilog, flog, state):
    """One chunk of the stabilized chunkwise-parallel mLSTM.

    q,k,v: (B, H, W, dh); ilog/flog: (B, H, W) log input gate / log forget.
    state: (C, n, m) with C (B,H,dh,dh), n (B,H,dh), m (B,H); C and n stored
    at scale exp(m).  Returns (h, new_state), h (B, H, W, dh).
    """
    B, H, W, dh = q.shape
    C, n, m = state
    b = torch.cumsum(flog, dim=-1)                        # (B,H,W) inclusive
    btot = b[..., -1]
    # intra-chunk log decay: logD[i,j] = b_i - b_j + ilog_j for j <= i
    logD = b[..., :, None] - b[..., None, :] + ilog[..., None, :]
    tri = torch.tril(torch.ones((W, W), dtype=torch.bool, device=q.device))
    logD = logD.masked_fill(~tri, -math.inf)
    inter_log = b + m[..., None]                          # (B,H,W)
    m_i = torch.maximum(logD.amax(dim=-1), inter_log)     # (B,H,W)
    wgt = torch.exp(logD - m_i[..., None])                # (B,H,W,W)
    inter_scale = torch.exp(inter_log - m_i)              # (B,H,W)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bhwd,bhtd->bhwt", q, k) * scale
    num = torch.einsum("bhwt,bhtd->bhwd", wgt * scores, v) \
        + inter_scale[..., None] * torch.einsum("bhwd,bhde->bhwe", q * scale, C)
    # C is stored k-major: C[d, e] = Σ i_t k_d v_e, so q·C = (q·k)·v
    den_vec = torch.einsum("bhwt,bhtd->bhwd", wgt, k) \
        + inter_scale[..., None] * n[..., None, :]
    den = torch.abs(torch.einsum("bhwd,bhwd->bhw", q * scale, den_vec))
    h = num / torch.maximum(den, torch.exp(-m_i))[..., None]
    # state update (stored at scale exp(m_new))
    upd_log = btot[..., None] - b + ilog                  # (B,H,W)
    m_new = torch.maximum(m + btot, upd_log.amax(dim=-1))
    upd = torch.exp(upd_log - m_new[..., None])
    decay = torch.exp(m + btot - m_new)
    C_new = C * decay[..., None, None] \
        + torch.einsum("bhw,bhwd,bhwe->bhde", upd, k, v)
    n_new = n * decay[..., None] + torch.einsum("bhw,bhwd->bhd", upd, k)
    return h, (C_new, n_new, m_new)


MLSTM_REGION_AXES = {"wq": (None, "qkv"), "wk": (None, "qkv"),
                     "wv": (None, "qkv"), "w_if": (None, None),
                     "b_if": (None,), "wo": ("qkv", None)}


def mlstm_apply(p, x, *, cfg, mode: str, cache=None, pos=None, chunk: int = 128,
                mesh=None):
    """On a mesh, the heads this rank's ``qkv`` columns touch, and of them
    its value columns (module docstring)."""
    if is_dtensor(x):
        return mixer_region(mlstm_apply, p, x, axes=MLSTM_REGION_AXES,
                            cache=cache, cache_axes=RNN_CACHE_AXES["mlstm"],
                            split=one_axis("qkv"), cfg=cfg, mode=mode, pos=pos)
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    cdt = torch_dtype(cfg.compute_dtype)
    xq = x.to(cdt)
    q, k, v = (xq @ p[w].to(cdt) for w in ("wq", "wk", "wv"))
    h0, h1, e0 = 0, H, 0
    if mesh is not None:
        axis = one_axis("qkv", mesh)
        me = axis_rank(mesh, axis) if axis else 0
        cols = rank_chunks(H * dh, mesh, axis)
        spans = _head_spans(cols, dh)
        (h0, h1), (c0, c1) = spans[me], cols[me]
        wide = [(a * dh, b * dh) for a, b in spans]
        q = exchange(q, mesh, axis, -1, cols, -1, wide)
        k = exchange(k, mesh, axis, -1, cols, -1, wide)
        # each head's value columns split as they come, where every rank's
        # columns are whole heads or lie in one head; else whole heads
        if all(b - a == 1 or (c1_ - c0_) == (b - a) * dh
               for (a, b), (c0_, c1_) in zip(spans, cols)):
            e0 = c0 - h0 * dh
        else:
            v = exchange(v, mesh, axis, -1, cols, -1, wide)
    nh = h1 - h0

    def heads(t):
        return t.reshape(B, S, nh, -1).transpose(1, 2).float()

    q32, k32, v32 = heads(q), heads(k), heads(v)
    w_if, b_if = p["w_if"], p["b_if"]
    if nh < H:          # this rank's heads' input and forget gates only
        w_if = torch.cat([w_if[:, h0:h1], w_if[:, H + h0:H + h1]], dim=1)
        b_if = torch.cat([b_if[h0:h1], b_if[H + h0:H + h1]])
    gates = (xq @ w_if.to(cdt) + b_if.to(cdt)).float()
    ilog = gates[..., :nh].transpose(1, 2)                # (B,H,S) input pre-act
    flog = F.logsigmoid(gates[..., nh:]).transpose(1, 2)

    if cache is not None:
        state = (cache["C"][:, h0:h1, :, e0:e0 + v32.shape[-1]],
                 cache["n"][:, h0:h1], cache["m"][:, h0:h1])
    else:
        state = (torch.zeros((B, nh, dh, v32.shape[-1]), device=x.device),
                 torch.zeros((B, nh, dh), device=x.device),
                 torch.full((B, nh), -1e30, device=x.device))

    if mode == "decode":
        h, state = _mlstm_chunk(q32, k32, v32, ilog, flog, state)
        hs = h.transpose(1, 2)                            # (B,1,H,dh)
    else:
        W = min(chunk, S)
        if S % W:
            raise ValueError(f"mLSTM prefill of {S} tokens is not a whole "
                             f"number of {W}-token chunks")
        outs = []
        for c in range(S // W):
            sl = slice(c * W, (c + 1) * W)
            h, state = _mlstm_chunk(q32[:, :, sl], k32[:, :, sl],
                                    v32[:, :, sl], ilog[..., sl],
                                    flog[..., sl], state)
            outs.append(h)
        hs = torch.cat(outs, dim=2).transpose(1, 2)       # (B,S,H,dh)

    hs = hs.to(cdt).reshape(B, S, -1)
    new_cache = {"C": state[0], "n": state[1], "m": state[2]} \
        if mode in ("prefill", "decode") else None
    if mesh is None:
        return (hs @ p["wo"].to(cdt)).to(x.dtype), new_cache
    own = (c0 - h0 * dh - e0, c1 - h0 * dh - e0)        # this rank's columns
    y = all_reduce(hs[..., own[0]:own[1]] @ p["wo"].to(cdt), mesh, axis)
    if new_cache is not None:
        C = new_cache["C"].permute(0, 2, 1, 3).reshape(B, dh, -1)
        C = exchange(C[..., own[0]:own[1]], mesh, axis, -1, cols, -1,
                     [(0, H * dh)] * len(cols))
        new_cache = {"C": C.reshape(B, dh, H, dh).permute(0, 2, 1, 3),
                     "n": _gather_heads(new_cache["n"], spans, me, mesh, axis),
                     "m": _gather_heads(new_cache["m"], spans, me, mesh, axis)}
    return y.to(x.dtype), new_cache


def mlstm_recurrent_oracle(p, x, *, cfg):
    """Step-by-step recurrent mLSTM (float32): test oracle for the chunkwise
    path."""
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    x32 = x.float()
    q = (x32 @ p["wq"].float()).reshape(B, S, H, dh)
    k = (x32 @ p["wk"].float()).reshape(B, S, H, dh)
    v = (x32 @ p["wv"].float()).reshape(B, S, H, dh)
    gates = x32 @ p["w_if"].float() + p["b_if"].float()
    ilog = gates[..., :H]
    flog = F.logsigmoid(gates[..., H:])
    scale = 1.0 / math.sqrt(dh)
    C = torch.zeros((B, H, dh, dh), device=x.device)
    n = torch.zeros((B, H, dh), device=x.device)
    m = torch.full((B, H), -1e30, device=x.device)
    hs = []
    for t in range(S):
        m_new = torch.maximum(flog[:, t] + m, ilog[:, t])
        f_ = torch.exp(flog[:, t] + m - m_new)
        i_ = torch.exp(ilog[:, t] - m_new)
        C = f_[..., None, None] * C + i_[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", k[:, t], v[:, t])
        n = f_[..., None] * n + i_[..., None] * k[:, t]
        num = torch.einsum("bhd,bhde->bhe", q[:, t] * scale, C)
        den = torch.abs(torch.einsum("bhd,bhd->bh", q[:, t] * scale, n))
        hs.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    hs = torch.stack(hs, dim=1)                           # (B,S,H,dh)
    return hs.reshape(B, S, H * dh) @ p["wo"].float()


# ---------------------------------------------------------------------------
# sLSTM (xLSTM): scalar memory with hidden-state feedback (sequential)
# ---------------------------------------------------------------------------

def slstm_defs(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    H, dh = cfg.n_heads, cfg.head_dim
    hd = H * dh
    return {
        "w_x": PDef((d, 4 * hd), ("dmodel_fsdp", "qkv")),
        "r_h": PDef((H, dh, 4 * dh), (None, None, None), scale=0.5),
        "b": PDef((4 * hd,), (None,), init="zeros"),
        "wo": PDef((hd, d), ("qkv", "dmodel_fsdp")),
    }


SLSTM_REGION_AXES = {"w_x": (None, "qkv"), "r_h": (None, None, None),
                     "b": (None,), "wo": ("qkv", None)}


def _slstm_step(carry, x_t, consts):
    c, n, m, h = carry
    g = x_t[0] + torch.einsum("bhd,hde->bhe", h, consts[0])
    z_, i_, f_, o_ = g.chunk(4, dim=-1)
    z = torch.tanh(z_)
    o = torch.sigmoid(o_)
    flog = F.logsigmoid(f_)
    m_new = torch.maximum(flog + m, i_)
    fs = torch.exp(flog + m - m_new)
    is_ = torch.exp(i_ - m_new)
    c = fs * c + is_ * z
    n = fs * n + is_
    h = o * c / torch.clamp_min(n, 1e-6)
    return (c, n, m_new, h), h


def slstm_apply(p, x, *, cfg, mode: str, cache=None, pos=None, mesh=None):
    """On a mesh, the heads this rank's ``qkv`` columns of ``w_x`` touch
    (module docstring)."""
    if is_dtensor(x):
        return mixer_region(slstm_apply, p, x, axes=SLSTM_REGION_AXES,
                            cache=cache, cache_axes=RNN_CACHE_AXES["slstm"],
                            split=one_axis("qkv"), cfg=cfg, mode=mode, pos=pos)
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    hd = H * dh
    pre = x.float() @ p["w_x"].float()
    h0, h1 = 0, H
    if mesh is not None:
        axis = one_axis("qkv", mesh)
        me = axis_rank(mesh, axis) if axis else 0
        cols = rank_chunks(4 * hd, mesh, axis)
        spans = _head_spans(cols, 4 * dh)
        h0, h1 = spans[me]
        pre = exchange(pre, mesh, axis, -1, cols, -1,
                       [(a * 4 * dh, b * 4 * dh) for a, b in spans])
    nh = h1 - h0
    pre = (pre + p["b"][h0 * 4 * dh:h1 * 4 * dh].float()).reshape(B, S, nh, 4 * dh)
    r_h = p["r_h"][h0:h1].float()

    if cache is not None:
        state = tuple(cache[k][:, h0:h1] for k in ("c", "n", "m", "h"))
    else:
        state = (torch.zeros((B, nh, dh), device=x.device),
                 torch.full((B, nh, dh), 1e-6, device=x.device),
                 torch.full((B, nh, dh), -1e30, device=x.device),
                 torch.zeros((B, nh, dh), device=x.device))
    state, hs = token_loop(_slstm_step, state, (pre,), S, (r_h,))  # (B,S,H,dh)
    new_cache = (dict(zip(("c", "n", "m", "h"), state))
                 if mode in ("prefill", "decode") else None)
    cdt = torch_dtype(cfg.compute_dtype)
    hs = hs.reshape(B, S, nh * dh)
    if mesh is None:
        return (hs.to(cdt) @ p["wo"].to(cdt)).to(x.dtype), new_cache
    # this rank's rows of wo: the owned heads' outputs re-chunked to them
    own = _owners(spans)
    lo, hi = own[me]
    hs = exchange(hs[..., (lo - h0) * dh:(hi - h0) * dh], mesh, axis, -1,
                  [(a * dh, b * dh) for a, b in own], -1,
                  rank_chunks(hd, mesh, axis))
    y = all_reduce(hs.to(cdt) @ p["wo"].to(cdt), mesh, axis)
    if new_cache is not None:
        new_cache = {k: _gather_heads(v, spans, me, mesh, axis)
                     for k, v in new_cache.items()}
    return y.to(x.dtype), new_cache
