"""Recurrent mixers: RG-LRU (RecurrentGemma/Griffin), mLSTM and sLSTM
(xLSTM): the port of ``repro.models.recurrent``.

Prefill runs mLSTM chunkwise-parallel over the sequence.  RG-LRU loops over
it with the decode step's own recurrence in float32, in place of the
reference's associative scan, so that a prefill row and a decode step
round alike (a log-depth scan rounds differently, and at bf16 compute
that difference grows through the layers: PERF.md, PR 21).  sLSTM feeds
its hidden state back into the gates and loops too.  Decode is one
recurrent step with O(1) state.

On a mesh the reference constrains nothing inside these mixers, so each
runs as a region over this rank's batch rows with its weights gathered
(:func:`repro_torch.models.sharding.mixer_region`); its states leave placed
by the cache axes (RG-LRU's ``h`` split over ``model`` along
``rnn_state``).  Every ``model`` rank computes the same thing, so in
training the gradients leave the region replicated over ``model`` and
partial over the batch axes.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .config import torch_dtype
from .layers import PDef
from .sharding import is_dtensor, mixer_region

RNN_CACHE_AXES = {
    "rglru": {"h": ("batch", "rnn_state")},
    "mlstm": {"C": ("batch", "heads", None, None), "n": ("batch", "heads", None),
              "m": ("batch", "heads")},
    "slstm": {k: ("batch", "heads", None) for k in ("c", "n", "m", "h")},
}


def _on_mesh(fn, kind, p, x, cfg, mode, cache, pos):
    """``fn`` as a region over local shards (its ``mesh`` argument unused:
    the math is the one-device math on this rank's batch rows, the same on
    every ``model`` rank, so the gradients are not partial over it)."""
    return mixer_region(lambda p, x, cache, mesh, **kw: fn(p, x, cache=cache,
                                                           **kw),
                        p, x, cache=cache, cache_axes=RNN_CACHE_AXES[kind],
                        split_model=False, cfg=cfg, mode=mode, pos=pos)

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


def _rglru_coeffs(p, u, cdt):
    """Per-step (a_t, b_t) of the linear recurrence h = a⊙h_prev + b."""
    r = torch.sigmoid((u @ p["w_rec_gate"].to(cdt)).float())
    i = torch.sigmoid((u @ p["w_inp_gate"].to(cdt)).float())
    log_a = -RGLRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated = i * u.float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * gated
    return a, b


def rglru_apply(p, x, *, cfg, mode: str, cache=None, pos=None):
    """x: (B, S, D) → (y, new_cache);  cache = {'h': (B, w)} float32."""
    if is_dtensor(x):
        return _on_mesh(rglru_apply, "rglru", p, x, cfg, mode, cache, pos)
    B, S, D = x.shape
    cdt = torch_dtype(cfg.compute_dtype)
    xq = x.to(cdt)
    u = xq @ p["w_in"].to(cdt)                           # (B, S, w)
    gate = F.gelu(xq @ p["w_gate"].to(cdt), approximate="tanh")
    a, b = _rglru_coeffs(p, u, cdt)                      # float32 (B, S, w)

    if mode == "decode":
        h = a[:, 0] * cache["h"] + b[:, 0]
        hs = h[:, None]
        new_cache = {"h": h}
    else:
        # the decode step's recurrence, step by step: each prefill row is
        # rounded exactly as a decode step would round it
        h = torch.zeros_like(a[:, 0]) if cache is None else cache["h"]
        hs = []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        hs = torch.stack(hs, dim=1)                      # (B, S, w)
        new_cache = {"h": h} if mode == "prefill" else None
    y = (hs.to(cdt) * gate) @ p["w_out"].to(cdt)
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


def mlstm_apply(p, x, *, cfg, mode: str, cache=None, pos=None, chunk: int = 128):
    if is_dtensor(x):
        return _on_mesh(mlstm_apply, "mlstm", p, x, cfg, mode, cache, pos)
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    cdt = torch_dtype(cfg.compute_dtype)
    xq = x.to(cdt)

    def heads(w):
        return (xq @ w.to(cdt)).reshape(B, S, H, dh).transpose(1, 2).float()

    q32, k32, v32 = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    gates = (xq @ p["w_if"].to(cdt) + p["b_if"].to(cdt)).float()
    ilog = gates[..., :H].transpose(1, 2)                 # (B,H,S) input pre-act
    flog = F.logsigmoid(gates[..., H:]).transpose(1, 2)

    if cache is not None:
        state = (cache["C"], cache["n"], cache["m"])
    else:
        state = (torch.zeros((B, H, dh, dh), device=x.device),
                 torch.zeros((B, H, dh), device=x.device),
                 torch.full((B, H), -1e30, device=x.device))

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

    new_cache = {"C": state[0], "n": state[1], "m": state[2]} \
        if mode in ("prefill", "decode") else None
    y = hs.to(cdt).reshape(B, S, H * dh) @ p["wo"].to(cdt)
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


def slstm_apply(p, x, *, cfg, mode: str, cache=None, pos=None):
    if is_dtensor(x):
        return _on_mesh(slstm_apply, "slstm", p, x, cfg, mode, cache, pos)
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    hd = H * dh
    pre = x.float() @ p["w_x"].float() + p["b"].float()
    pre = pre.reshape(B, S, H, 4 * dh)
    r_h = p["r_h"].float()

    if cache is not None:
        c, n, m, h = cache["c"], cache["n"], cache["m"], cache["h"]
    else:
        c = torch.zeros((B, H, dh), device=x.device)
        n = torch.full((B, H, dh), 1e-6, device=x.device)
        m = torch.full((B, H, dh), -1e30, device=x.device)
        h = torch.zeros((B, H, dh), device=x.device)

    hs = []
    for t in range(S):
        g = pre[:, t] + torch.einsum("bhd,hde->bhe", h, r_h)
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
        m = m_new
        hs.append(h)
    hs = torch.stack(hs, dim=1)                           # (B,S,H,dh)
    new_cache = ({"c": c, "n": n, "m": m, "h": h}
                 if mode in ("prefill", "decode") else None)
    cdt = torch_dtype(cfg.compute_dtype)
    y = hs.reshape(B, S, hd).to(cdt) @ p["wo"].to(cdt)
    return y.to(x.dtype), new_cache
