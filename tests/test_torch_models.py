"""The LM plane's layers in the PyTorch port against the JAX package's.

Every module of ``repro_torch.models`` that the serving path runs (norms,
RoPE, the three attentions, RG-LRU, mLSTM, sLSTM, the MoE router and dense
fallback, SwiGLU, the initializer) gets the same numpy inputs, made from a
seed, as its ``repro.models`` counterpart, at float32 on the CPU.  The
bound is rel 1e-5 of max|reference| unless a test states another.

One behaviour differs on purpose: the port's ``blockwise_attention`` masks
its KV padding in causal mode, where the reference lets zero-padded keys
into the softmax (``src/repro/models/layers.py:136-138``); that case is
held against a float64 oracle instead.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import load_all as jax_load_all
from repro.configs.shapes import reduced_config as jax_reduced
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import recurrent as jr
from repro_torch.configs import load_all
from repro_torch.configs.shapes import reduced_config
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import recurrent as tr

jax_load_all()
load_all()

REL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.tensor(np.asarray(a))


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_params(defs_fn, cfg, seed):
    p = jl.init_from_defs(defs_fn(cfg), jax.random.PRNGKey(seed), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, p)


def _port(p):
    return tl.tree_map(_t, p)


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["rms_norm", "head_rms_norm"])
def test_norms_match_jax(fn):
    rng = np.random.default_rng(0)
    x = _normal(rng, 2, 5, 4, 16, scale=3.0)
    w = _normal(rng, 16) + 1.0
    want = getattr(jl, fn)(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = getattr(tl, fn)(_t(x), _t(w), 1e-6)
    assert _rel(got, want) < REL


@pytest.mark.parametrize("theta,positions", [
    (10_000.0, np.arange(7)), (1e6, np.arange(7)), (5e6, np.array([1023])),
])
def test_rope_matches_jax(theta, positions):
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, len(positions), 4, 32)
    want = jl.rope(jnp.asarray(x), jnp.asarray(positions), theta)
    got = tl.rope(_t(x), _t(positions), theta)
    assert _rel(got, want) < REL


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _qkv(seed, B, S, H, Hkv, dh, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (_normal(rng, B, S, H, dh), _normal(rng, B, T, Hkv, dh),
            _normal(rng, B, T, Hkv, dh))


@pytest.mark.parametrize("causal,window,kv_block,Hkv", [
    (True, 0, 8, 2), (True, 0, 24, 4), (True, 5, 8, 1), (False, 0, 6, 2),
])
def test_blockwise_attention_matches_jax_where_no_padding(causal, window,
                                                          kv_block, Hkv):
    """``kv_block`` divides T = 24, so the reference pads nothing."""
    q, k, v = _qkv(2, 2, 24, 4, Hkv, 8)
    pos = np.arange(24)
    want = jl.blockwise_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                  causal=causal, window=window,
                                  kv_block=kv_block)
    got = tl.blockwise_attention(*map(_t, (q, k, v, pos, pos)), causal=causal,
                                 window=window, kv_block=kv_block)
    assert _rel(got, want) < REL


def _attention_oracle(q, k, v, *, causal, window):
    """float64 softmax(QKᵀ/√dh)V with GQA, in numpy."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), H // Hkv, axis=2)
    vv = np.repeat(v.astype(np.float64), H // Hkv, axis=2)
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kk) / math.sqrt(dh)
    i, j = np.arange(S)[:, None], np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok &= j <= i
    if window:
        ok &= j > i - window
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhst,bthd->bshd", p, vv)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_blockwise_attention_default_block_matches_float64_oracle(causal, window):
    """T = 12 with the default kv_block = 1024: 1,012 pad slots, masked in
    every mode (the intended behaviour the reference misses when causal)."""
    q, k, v = _qkv(3, 2, 12, 4, 4, 8)
    pos = np.arange(12)
    want = _attention_oracle(q, k, v, causal=causal, window=window)
    got = tl.blockwise_attention(*map(_t, (q, k, v, pos, pos)), causal=causal,
                                 window=window)
    assert _rel(got, want) < REL
    ref = np.asarray(jl.blockwise_attention(
        *map(jnp.asarray, (q, k, v, pos, pos)), causal=causal, window=window))
    if causal and not window:
        # the reference's fault: its zero-padded keys enter the softmax
        assert _rel(ref, want) > 0.1
    else:
        assert _rel(ref, want) < REL


@pytest.mark.parametrize("S,W,Hkv", [(32, 8, 4), (30, 8, 1), (5, 8, 2)])
def test_local_attention_matches_jax(S, W, Hkv):
    q, k, v = _qkv(4, 2, S, 4, Hkv, 8)
    pos = np.arange(S)
    want = jl.local_attention(*map(jnp.asarray, (q, k, v, pos, pos)), window=W)
    got = tl.local_attention(*map(_t, (q, k, v, pos, pos)), window=W)
    assert _rel(got, want) < REL
    oracle = _attention_oracle(q, k, v, causal=True, window=W)
    assert _rel(got, oracle) < REL


@pytest.mark.parametrize("pos,window,Hkv", [(0, 0, 2), (9, 0, 2), (13, 4, 1),
                                            (15, 0, 4)])
def test_decode_attention_matches_jax(pos, window, Hkv):
    q, k, v = _qkv(5, 2, 1, 4, Hkv, 16, T=16)
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               pos, window=window)
    got = tl.decode_attention(_t(q), _t(k), _t(v), pos, window=window)
    assert _rel(got, want) < REL


@pytest.mark.parametrize("arch,kind", [("qwen3-4b", "attn"),
                                       ("qwen2.5-14b", "attn"),
                                       ("recurrentgemma-2b", "attn_local"),
                                       ("deepseek-v2-236b", "mla")])
def test_attention_blocks_match_jax(arch, kind):
    """attn_apply / mla_apply: a decode step at position 11 against the
    same random 16-slot cache (prefill is held in tests/test_torch_lm.py
    at a length where the reference pads nothing)."""
    cfg, jcfg = reduced_config(arch), jax_reduced(arch)
    defs = jl.mla_defs if kind == "mla" else jl.attn_defs
    p = _jax_params(defs, jcfg, 6)
    rng = np.random.default_rng(6)
    x = _normal(rng, 2, 1, cfg.d_model)
    apply_j = jl.mla_apply if kind == "mla" else \
        (lambda *a, **kw: jl.attn_apply(*a, local=kind == "attn_local", **kw))
    apply_t = tl.mla_apply if kind == "mla" else \
        (lambda *a, **kw: tl.attn_apply(*a, local=kind == "attn_local", **kw))
    names = ("c_kv",) if kind == "mla" else ("k", "v")
    shapes = {"c_kv": (2, 16, cfg.kv_lora_rank),
              "k": (2, 16, cfg.n_kv_heads, cfg.head_dim)}
    cache = {n: _normal(rng, *shapes.get(n, shapes["k"])) for n in names}
    want, wc = apply_j(p, jnp.asarray(x), cfg=jcfg, mode="decode",
                       cache={n: jnp.asarray(c) for n, c in cache.items()},
                       pos=11)
    got, gc = apply_t(_port(p), _t(x), cfg=cfg, mode="decode",
                      cache={n: _t(c) for n, c in cache.items()}, pos=11)
    assert _rel(got, want) < REL
    for n in names:
        assert _rel(gc[n], wc[n]) < REL


def test_attention_decode_raises_past_the_cache():
    cfg, jcfg = reduced_config("qwen3-4b"), jax_reduced("qwen3-4b")
    p = _port(_jax_params(jl.attn_defs, jcfg, 7))
    cache = {n: torch.zeros(1, 4, cfg.n_kv_heads, cfg.head_dim)
             for n in ("k", "v")}
    x = torch.zeros(1, 1, cfg.d_model)
    tl.attn_apply(p, x, cfg=cfg, mode="decode", cache=cache, pos=3)
    with pytest.raises(IndexError, match="outside a cache of 4"):
        tl.attn_apply(p, x, cfg=cfg, mode="decode", cache=cache, pos=4)


def test_swiglu_matches_jax():
    cfg, jcfg = reduced_config("qwen3-4b"), jax_reduced("qwen3-4b")
    p = _jax_params(jl.swiglu_defs, jcfg, 8)
    x = _normal(np.random.default_rng(8), 2, 7, cfg.d_model)
    want = jl.swiglu_apply(p, jnp.asarray(x), cfg=jcfg)
    got = tl.swiglu_apply(_port(p), _t(x), cfg=cfg)
    assert _rel(got, want) < REL


# ---------------------------------------------------------------------------
# Recurrent mixers
# ---------------------------------------------------------------------------

def test_rglru_matches_jax_and_decode_matches_prefill_tail():
    cfg, jcfg = reduced_config("recurrentgemma-2b"), jax_reduced("recurrentgemma-2b")
    p = _jax_params(jr.rglru_defs, jcfg, 10)
    x = _normal(np.random.default_rng(10), 2, 9, cfg.d_model)
    want, wc = jr.rglru_apply(p, jnp.asarray(x), cfg=jcfg, mode="prefill")
    got, gc = tr.rglru_apply(_port(p), _t(x), cfg=cfg, mode="prefill")
    assert _rel(got, want) < REL
    assert _rel(gc["h"], wc["h"]) < REL
    _, part = tr.rglru_apply(_port(p), _t(x[:, :8]), cfg=cfg, mode="prefill")
    step, sc = tr.rglru_apply(_port(p), _t(x[:, 8:9]), cfg=cfg, mode="decode",
                              cache=part)
    # the prefill loops with the decode step's recurrence: equal bit for bit
    assert torch.equal(step, got[:, 8:9])
    assert torch.equal(sc["h"], gc["h"])
    jstep, _ = jr.rglru_apply(p, jnp.asarray(x[:, 8:9]), cfg=jcfg,
                              mode="decode",
                              cache={"h": jnp.asarray(part["h"].numpy())})
    assert _rel(step, jstep) < REL


@pytest.mark.parametrize("S,chunk", [(32, 8), (12, 128)])
def test_mlstm_chunkwise_matches_jax_and_both_oracles(S, chunk):
    cfg, jcfg = reduced_config("xlstm-350m"), jax_reduced("xlstm-350m")
    p = _jax_params(jr.mlstm_defs, jcfg, 11)
    x = _normal(np.random.default_rng(11), 2, S, cfg.d_model, scale=0.5)
    want, wc = jr.mlstm_apply(p, jnp.asarray(x), cfg=jcfg, mode="prefill",
                              chunk=chunk)
    got, gc = tr.mlstm_apply(_port(p), _t(x), cfg=cfg, mode="prefill",
                             chunk=chunk)
    assert _rel(got, want) < REL
    for n in ("C", "n", "m"):
        assert _rel(gc[n], wc[n]) < REL
    oracle_t = tr.mlstm_recurrent_oracle(_port(p), _t(x), cfg=cfg)
    oracle_j = jr.mlstm_recurrent_oracle(p, jnp.asarray(x), cfg=jcfg)
    assert _rel(oracle_t, oracle_j) < REL
    # chunkwise against the step-by-step recurrence: the reference's own
    # bound (tests/test_models.py), reached here at float32 rounding
    assert _rel(got, oracle_t) < 1e-4


def test_mlstm_decode_matches_jax():
    cfg, jcfg = reduced_config("xlstm-350m"), jax_reduced("xlstm-350m")
    p = _jax_params(jr.mlstm_defs, jcfg, 12)
    x = _normal(np.random.default_rng(12), 2, 9, cfg.d_model, scale=0.5)
    _, wc = jr.mlstm_apply(p, jnp.asarray(x[:, :8]), cfg=jcfg, mode="prefill")
    want, _ = jr.mlstm_apply(p, jnp.asarray(x[:, 8:]), cfg=jcfg,
                             mode="decode", cache=wc)
    cache = {n: _t(c) for n, c in wc.items()}
    got, _ = tr.mlstm_apply(_port(p), _t(x[:, 8:]), cfg=cfg, mode="decode",
                            cache=cache)
    assert _rel(got, want) < REL
    full, _ = tr.mlstm_apply(_port(p), _t(x), cfg=cfg, mode="prefill")
    assert _rel(got, full[:, 8:]) < 1e-4


def test_slstm_matches_jax():
    cfg, jcfg = reduced_config("xlstm-350m"), jax_reduced("xlstm-350m")
    p = _jax_params(jr.slstm_defs, jcfg, 13)
    x = _normal(np.random.default_rng(13), 2, 11, cfg.d_model)
    want, wc = jr.slstm_apply(p, jnp.asarray(x), cfg=jcfg, mode="prefill")
    got, gc = tr.slstm_apply(_port(p), _t(x), cfg=cfg, mode="prefill")
    assert _rel(got, want) < REL
    for n in ("c", "n", "m", "h"):
        assert _rel(gc[n], wc[n]) < REL
    x1 = _normal(np.random.default_rng(14), 2, 1, cfg.d_model)
    want, _ = jr.slstm_apply(p, jnp.asarray(x1), cfg=jcfg, mode="decode",
                             cache=wc)
    got, _ = tr.slstm_apply(_port(p), _t(x1), cfg=cfg, mode="decode", cache=gc)
    assert _rel(got, want) < REL


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------

MOE_ARCHS = ("kimi-k2-1t-a32b", "deepseek-v2-236b")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_jax(arch):
    cfg, jcfg = reduced_config(arch), jax_reduced(arch)
    p = _jax_params(jmoe.moe_defs, jcfg, 15)
    x = _normal(np.random.default_rng(15), 40, cfg.d_model)
    wt, we, wa = jmoe._route(jnp.asarray(x), jnp.asarray(p["router"]), jcfg.moe)
    gt, ge, ga = tmoe._route(_t(x), _t(p["router"]), cfg.moe)
    assert np.array_equal(ge.numpy(), np.asarray(we))
    assert _rel(gt, wt) < REL
    assert abs(float(ga) - float(wa)) < REL * abs(float(wa))


def test_top_k_breaks_ties_as_jax():
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.0, 0.5],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 4)
    gv, gi = tmoe.top_k(_t(x), 4)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("n,buckets", [(50, 7), (1, 3), (64, 1)])
def test_bucket_slots_match_jax(n, buckets):
    ids = np.random.default_rng(n).integers(0, buckets, n).astype(np.int32)
    want = jmoe.bucket_slots(jnp.asarray(ids), buckets)
    got = tmoe.bucket_slots(_t(ids), buckets)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_fallback_matches_jax(arch):
    cfg, jcfg = reduced_config(arch), jax_reduced(arch)
    p = _jax_params(jmoe.moe_defs, jcfg, 16)
    x = _normal(np.random.default_rng(16), 2, 9, cfg.d_model)
    want, wa = jmoe._moe_dense_fallback(p, jnp.asarray(x), jcfg)
    got, ga = tmoe.moe_apply(_port(p), _t(x), cfg=cfg)
    assert _rel(got, want) < REL
    assert abs(float(ga) - float(wa)) < REL * abs(float(wa))


# ---------------------------------------------------------------------------
# Initializer
# ---------------------------------------------------------------------------

def test_init_from_defs_statistics_by_leaf():
    """Each normal leaf's mean and std against 0 and scale/√fan_in (6σ of
    the sample statistics), the JAX package's draw beside it; ones and
    zeros exact; the same generator seed draws the same tree."""
    cfg = reduced_config("xlstm-350m")
    defs = {"mlstm": tr.mlstm_defs(cfg), "slstm": tr.slstm_defs(cfg),
            "moe": tmoe.moe_defs(reduced_config("kimi-k2-1t-a32b"))}
    got = tl.init_from_defs(defs, torch.Generator().manual_seed(0),
                            device="cpu")
    jdefs = {"mlstm": jr.mlstm_defs(cfg), "slstm": jr.slstm_defs(cfg),
             "moe": jmoe.moe_defs(reduced_config("kimi-k2-1t-a32b"))}
    ref = jl.init_from_defs(jdefs, jax.random.PRNGKey(0))
    again = tl.init_from_defs(defs, torch.Generator().manual_seed(0),
                              device="cpu")
    for grp, leaves in defs.items():
        for name, pd in leaves.items():
            t = got[grp][name].numpy().astype(np.float64)
            assert t.shape == pd.shape
            assert torch.equal(got[grp][name], again[grp][name])
            if pd.init != "normal":
                assert np.all(t == (1.0 if pd.init == "ones" else 0.0))
                continue
            fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
            std = pd.scale / math.sqrt(fan_in)
            n = t.size
            assert abs(t.mean()) < 6 * std / math.sqrt(n), (grp, name)
            assert abs(t.std() / std - 1) < 6 / math.sqrt(2 * n), (grp, name)
            r = np.asarray(ref[grp][name], np.float64)
            assert abs(r.std() / std - 1) < 6 / math.sqrt(2 * n), (grp, name)


def test_init_from_defs_draws_on_the_generator_only():
    defs = {"w": tl.PDef((64, 32), (None, None))}
    torch.manual_seed(1)
    a = tl.init_from_defs(defs, torch.Generator().manual_seed(5), device="cpu")
    torch.manual_seed(2)
    b = tl.init_from_defs(defs, torch.Generator().manual_seed(5), device="cpu")
    c = tl.init_from_defs(defs, torch.Generator().manual_seed(6), device="cpu")
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])
