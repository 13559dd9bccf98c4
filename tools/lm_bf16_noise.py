"""How far bf16 compute moves an LM's logits, in both packages, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/lm_bf16_noise.py [--layers 8 26]

A RecurrentGemma-2B-shaped model (its block pattern, d = 1024, 4 heads of
256, one KV head, d_ff 3072, vocabulary 4096) drawn once by the JAX
package and carried into the port.  For 6 greedy steps after a 32-token
prompt (batch 2) it prints, per package, the largest gap (of max|logit|)

* between a bf16 decode step and the bf16 teacher-forced prefill of the
  same tokens, and
* between the bf16 prefill and the float32 prefill of the same tokens
  (the bf16 rounding noise of the model's depth),

then the port's per-block difference between a decode step's residual
stream and the prefill's last row: where the two first part and how the
difference grows.  The reference's attention here is local, so its known
causal-padding fault does not enter; its caches are padded by key name.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import load_all as jax_load_all
from repro.models import Model as JaxModel
from repro.models import get_config as jax_get_config
from repro_torch.configs import load_all
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import Model, get_config
import repro_torch.models.transformer as transformer

ARCH = "recurrentgemma-2b"
S, STEPS, VOCAB = 32, 6, 4096


def widths(layers: int) -> dict:
    return dict(d_model=1024, n_layers=layers, n_tail=2, d_ff=3072,
                vocab_size=VOCAB, n_heads=4, n_kv_heads=1, head_dim=256,
                rnn_state_dim=1024, compute_dtype="bfloat16")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def pad_jax_caches(caches, extra: int):
    return {gk: {key: {n: (jnp.pad(t, [(0, 0), (0, 0), (0, extra)]
                                   + [(0, 0)] * (t.ndim - 3))
                           if n in ("k", "v", "c_kv") else t)
                       for n, t in c.items()}
                 for key, c in g.items()}
            for gk, g in caches.items()}


def both_packages(layers: int):
    kw = widths(layers)
    jcfg = dataclasses.replace(jax_get_config(ARCH), **kw)
    cfg = dataclasses.replace(get_config(ARCH), **kw)
    j16, j32 = JaxModel(jcfg), JaxModel(dataclasses.replace(jcfg, compute_dtype="float32"))
    params = j16.init(jax.random.PRNGKey(0))
    m16 = Model.from_params(cfg, lm_params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, params)), device="cpu")
    m32 = Model.from_params(dataclasses.replace(cfg, compute_dtype="float32"),
                            m16.tree(), device="cpu")
    pre16 = jax.jit(lambda p, b: j16.prefill(p, b))
    pre32 = jax.jit(lambda p, b: j32.prefill(p, b))
    dec16 = jax.jit(j16.decode_step)
    toks = np.random.default_rng(0).integers(0, VOCAB, (2, S)).astype(np.int32)
    logits, caches = m16.prefill({"tokens": torch.tensor(toks)}, cache_len=S + STEPS)
    _, jcaches = pre16(params, {"tokens": jnp.asarray(toks)})
    jcaches = pad_jax_caches(jcaches, STEPS)
    cur, jcur = torch.tensor(toks), jnp.asarray(toks)
    gaps = {"port": [], "reference": []}
    noise = {"port": [], "reference": []}
    for t in range(STEPS):
        tok = logits[:, -1].argmax(-1)[:, None]
        jtok = jnp.asarray(tok.numpy().astype(np.int32))
        cur, jcur = torch.cat([cur, tok.int()], 1), jnp.concatenate([jcur, jtok], 1)
        logits, caches = m16.decode_step(tok, caches, S + t)
        p16, _ = m16.prefill({"tokens": cur})
        p32, _ = m32.prefill({"tokens": cur})
        jd, jcaches = dec16(params, jtok, jcaches, jnp.asarray(S + t))
        jp16, _ = pre16(params, {"tokens": jcur})
        jp32, _ = pre32(params, {"tokens": jcur})
        gaps["port"].append(rel(host(logits), host(p16)))
        gaps["reference"].append(rel(host(jd), host(jp16)))
        noise["port"].append(rel(host(p16), host(p32)))
        noise["reference"].append(rel(host(jp16), host(jp32)))
    for pkg in ("port", "reference"):
        print(f"{layers} layers, {pkg}: bf16 decode vs bf16 teacher-forced "
              f"prefill {max(gaps[pkg]):.3e}; bf16 prefill vs float32 prefill "
              f"{max(noise[pkg]):.3e}")
    return m16, toks


def first_parting(m16: Model, toks: np.ndarray):
    """Per block, max |decode residual - prefill last row| after the block."""
    seen = []
    apply_block = transformer.apply_block

    def record(kind, p, x, **kw):
        out = apply_block(kind, p, x, **kw)
        seen.append((kind, out[0][:, -1:].float().clone()))
        return out

    transformer.apply_block = record
    try:
        tt = torch.tensor(toks)
        _, caches = m16.prefill({"tokens": tt[:, :-1]}, cache_len=S)
        seen.clear()
        m16.decode_step(tt[:, -1:], caches, S - 1)
        dec = list(seen)
        seen.clear()
        m16.prefill({"tokens": tt})
        pre = list(seen)
    finally:
        transformer.apply_block = apply_block
    print("port, decode vs prefill residual after each block (max abs, "
          "scale): " + "; ".join(
              f"{k} {float((a - b).abs().max()):.3g} / {float(b.abs().max()):.3g}"
              for (k, a), (_, b) in zip(dec, pre)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[8, 26])
    args = ap.parse_args()
    jax_load_all()
    load_all()
    for layers in args.layers:
        m16, toks = both_packages(layers)
    first_parting(m16, toks)


if __name__ == "__main__":
    main()
