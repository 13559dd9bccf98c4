"""Whole LM models in the PyTorch port against the JAX package's.

All ten registered architectures at ``reduced_config``, float32 on the
CPU, weights drawn by the JAX package's ``Model.init`` and carried across
with ``repro_torch.convert.lm_params_from_jax``.

* Prefill logits equal the reference's at S = 1024, a multiple of the
  reference's ``kv_block`` (where its attention pads nothing), rel 1e-4.
* One decode step equals the reference's unedited ``decode_step`` fed the
  reference's own prefill caches, padded here by key name, rel 1e-4.
* The port's decode equals its own teacher-forced prefill for 3 steps at
  S = 10 and S = 12 (12 is Whisper's reduced ``encoder_seq``, which a pad
  rule by shape would mistake for a self-attention cache), rel 1e-5.
  The reference's decode does not (``src/repro/models/layers.py:131-138``
  lets padded keys into causal attention; ``src/repro/models/
  transformer.py:393-400`` never pads its group-stacked caches);
  ``test_reference_decode_faults_shown`` keeps both visible.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import load_all as jax_load_all
from repro.configs import shapes as jshapes
from repro.models import Model as JaxModel
from repro.models import init_cache as jax_init_cache
from repro_torch.configs import ARCH_IDS, load_all
from repro_torch.configs import shapes
from repro_torch.convert import lm_caches_from_jax, lm_params_from_jax
from repro_torch.models import Model, cache_len, get_config, init_cache
from repro_torch.models.layers import tree_map

jax_load_all()
load_all()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
REL_JAX = 1e-4      # port vs reference, whole models at float32
REL_SELF = 1e-5     # the port's decode vs its own teacher-forced prefill
SEQ_KEYS = ("k", "v", "c_kv")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _models(arch, seed=0):
    jcfg = jshapes.reduced_config(arch)
    cfg = shapes.reduced_config(arch)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jm, params, Model.from_params(cfg, lm_params_from_jax(cfg, np_params),
                                         device="cpu")


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "embed_stub":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _extend(model, batch, tok):
    """``batch`` with the token ``tok`` (B, 1) appended as decode embeds it."""
    out = dict(batch)
    if model.cfg.frontend == "embed_stub":
        out["embeds"] = torch.cat([batch["embeds"],
                                   model.token_embeds(tok).float()], dim=1)
    else:
        out["tokens"] = torch.cat([batch["tokens"], tok.to(batch["tokens"].dtype)],
                                  dim=1)
    return out


def _pad_jax_caches(caches, length):
    """The reference's group-stacked caches (G, B, S, ...) with the
    self-attention leaves padded to ``length`` slots by key name; the
    encoder's ':xattn' caches stay as they are."""
    out = {}
    for gk, groups in caches.items():
        out[gk] = {}
        for key, c in groups.items():
            if key.endswith(":xattn"):
                out[gk][key] = c
                continue
            out[gk][key] = {
                n: (jnp.pad(t, [(0, 0), (0, 0), (0, length - t.shape[2])]
                            + [(0, 0)] * (t.ndim - 3)) if n in SEQ_KEYS else t)
                for n, t in c.items()}
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    assert ARCH_IDS == JAX_ARCH_IDS
    for mine, ref in ((get_config(arch), jshapes.get_config(arch)),
                      (shapes.reduced_config(arch), jshapes.reduced_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.block_kinds() == ref.block_kinds()
        assert mine.n_params_estimate() == ref.n_params_estimate()
        assert mine.active_params_estimate() == ref.active_params_estimate()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_jax_at_a_multiple_of_kv_block(arch):
    jm, params, model = _models(arch)
    batch = _batch(model.cfg, 1, 1024)
    want, _ = jax.jit(lambda p, b: jm.prefill(p, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = model.prefill(_torch_batch(batch))
    assert got.shape == (1, 1, model.cfg.vocab_size)
    assert _rel(got, want) < REL_JAX


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_jax_fed_padded_caches(arch):
    """Both decode_steps from the reference's prefill caches of S = 10,
    padded here to 14 slots by key name; logits and the written caches."""
    jm, params, model = _models(arch, seed=1)
    S, T = 10, 14
    batch = _batch(model.cfg, 2, S, seed=1)
    _, jcaches = jax.jit(lambda p, b: jm.prefill(p, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    jcaches = _pad_jax_caches(jcaches, T)
    np_caches = jax.tree_util.tree_map(np.asarray, jcaches)
    caches = tree_map(torch.tensor, lm_caches_from_jax(model.cfg, np_caches))
    tok = np.array([[3], [7]], np.int32)
    want, wc = jax.jit(jm.decode_step)(params, jnp.asarray(tok), jcaches,
                                       jnp.asarray(S))
    got, gc = model.decode_step(torch.tensor(tok), caches, S)
    assert _rel(got, want) < REL_JAX
    want_caches = lm_caches_from_jax(model.cfg,
                                     jax.tree_util.tree_map(np.asarray, wc))
    for gk, gs in want_caches.items():
        for g, grp in enumerate(gs):
            for key, c in grp.items():
                for n, t in c.items():
                    assert _rel(gc[gk][g][key][n], t) < REL_JAX, (gk, g, key, n)


def _self_consistency_gap(model, batch, steps):
    """max over decode steps of rel |decode logits - teacher-forced prefill
    logits| (of max|prefill logits|), greedy tokens."""
    S = (batch.get("tokens", batch.get("embeds"))).shape[1]
    logits, caches = model.prefill(batch, cache_len=S + steps)
    gap = 0.0
    for t in range(steps):
        tok = logits[:, -1].argmax(-1)[:, None]
        batch = _extend(model, batch, tok)
        logits, caches = model.decode_step(tok, caches, S + t)
        want, _ = model.prefill(batch)
        gap = max(gap, _rel(logits, want))
    return gap


@pytest.mark.parametrize("S", [10, 12])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_teacher_forced_prefill(arch, S):
    _, _, model = _models(arch, seed=2)
    batch = _torch_batch(_batch(model.cfg, 2, S, seed=2))
    assert _self_consistency_gap(model, batch, 3) < REL_SELF


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_matches_jax_and_the_prefill_layout(arch):
    """init_cache: the reference's leaves (unstacked per group), K/V in the
    cache dtype and states in float32; a prefill to the same cache_len
    returns the same keys and shapes."""
    cfg = shapes.reduced_config(arch)
    mine = init_cache(cfg, 2, 9, device="cpu")
    ref = lm_caches_from_jax(cfg, jax.tree_util.tree_map(
        np.asarray, jax_init_cache(jshapes.reduced_config(arch), 2, 9)))
    _, _, model = _models(arch)
    _, pre = model.prefill(_torch_batch(_batch(cfg, 2, 6)), cache_len=9)
    assert set(mine) == set(ref) == set(pre)
    for gk in mine:
        assert len(mine[gk]) == len(ref[gk]) == len(pre[gk])
        for g, r, q in zip(mine[gk], ref[gk], pre[gk]):
            assert set(g) == set(r) == set(q)
            for key in g:
                for n, t in g[key].items():
                    assert tuple(t.shape) == r[key][n].shape
                    assert str(t.dtype).replace("torch.", "") == str(r[key][n].dtype)
                    assert q[key][n].shape == t.shape, (gk, key, n)


def test_prefill_pads_self_attention_caches_by_key_not_shape():
    """Whisper at S = encoder_seq = 12: the decoder's k/v grow to
    cache_len, the encoder's cross-attention k/v keep 12 slots."""
    _, _, model = _models("whisper-small")
    batch = _torch_batch(_batch(model.cfg, 2, 12))
    _, caches = model.prefill(batch, cache_len=16)
    grp = caches["blocks"][0]
    assert grp["0:attn"]["k"].shape[1] == 16
    assert grp["0:attn"]["v"].shape[1] == 16
    assert grp["0:xattn"]["k"].shape[1] == 12
    assert cache_len(caches) == 16


def test_reference_decode_faults_shown():
    """The reference's decode misses its own teacher-forced prefill on
    reduced Qwen3-4B (faults 1 and 2; it stays unedited), the port's does
    not, from the same weights."""
    jm, params, model = _models("qwen3-4b", seed=3)
    S = 12
    batch = _batch(model.cfg, 2, S, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, caches = jm.prefill(params, jb, cache_len=S + 4)
    # fault 2: the stacked caches keep S slots (shape[1] is the group axis)
    assert caches["blocks"]["0:attn"]["k"].shape == (1, 2, S, 2, 16)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    ref, _ = jm.decode_step(params, tok, caches, jnp.asarray(S))
    forced, _ = jm.prefill(params, {"tokens": jnp.concatenate(
        [jb["tokens"], tok], axis=1)})
    assert _rel(ref, forced) > 0.1
    assert _self_consistency_gap(model, _torch_batch(batch), 1) < REL_SELF


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_raises_past_the_cache(arch):
    _, _, model = _models(arch)
    batch = _torch_batch(_batch(model.cfg, 1, 6))
    logits, caches = model.prefill(batch, cache_len=7)
    tok = logits[:, -1].argmax(-1)[:, None]
    if cache_len(caches) is None:       # xLSTM: recurrent states only
        assert arch == "xlstm-350m"
        model.decode_step(tok, caches, 7)
        return
    logits, caches = model.decode_step(tok, caches, 6)
    with pytest.raises(ValueError, match="outside the caches' 7 slots"):
        model.decode_step(tok, caches, 7)


def test_input_specs_cover_all_cells():
    for arch in ARCH_IDS:
        for shape in shapes.SHAPES:
            ok, why = shapes.cell_is_applicable(arch, shape)
            assert (ok, why) == jshapes.cell_is_applicable(arch, shape)
            if not ok:
                continue
            specs = shapes.input_specs(arch, shape)
            ref = jshapes.input_specs(arch, shape)
            assert set(specs) == set(ref), (arch, shape)
            for k, (shp, dt) in specs.items():
                assert shp == ref[k].shape, (arch, shape, k)
                assert str(dt).replace("torch.", "") == str(ref[k].dtype)
    assert shapes.TRAIN_MICROBATCHES == jshapes.TRAIN_MICROBATCHES


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = shapes.reduced_config("qwen3-4b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model.init(cfg)
    out = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "serve_lm_torch.py"),
         "--reduced", "--gen", "2"], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode != 0 and "CUDA" in out.stderr


def test_serve_lm_example_on_the_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "serve_lm_torch.py"),
         "--arch", "recurrentgemma-2b", "--reduced", "--device", "cpu",
         "--batch", "2", "--prompt-len", "12", "--gen", "4"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "generated (2, 4) tokens" in out.stdout


@pytest.mark.parametrize("args", [[], ["--serve"]])
def test_quickstart_example_on_the_cpu(args):
    out = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "quickstart_torch.py"),
         "--device", "cpu"] + args, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    if args:
        assert "spend survives restart: True" in out.stdout
    else:
        assert "95%CI coverage=" in out.stdout
