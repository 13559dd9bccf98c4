"""Shared by the port's LM training parity tests: seeded numpy batches,
the JAX package's weights carried into the port, and the loss-and-gradient
check against ``jax.value_and_grad`` of the reference's ``Model.loss_fn``
(loss rel 1e-5; each gradient leaf rel 1e-4 of its max, float32 on the
CPU).  Architectures with causal global attention run at S = 1024, a
multiple of the reference's ``kv_block``: elsewhere its causal attention
lets zero-padded keys in (``tests/test_torch_lm.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import load_all as jax_load_all
from repro.configs import shapes as jshapes
from repro.models import Model as JaxModel
from repro_torch.configs import load_all
from repro_torch.configs import shapes
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves, tree_map

jax_load_all()
load_all()

REL_LOSS = 1e-5    # loss_fn, whole models at float32
REL_GRAD = 1e-4    # each gradient leaf, of its max


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def lm_batch(cfg, B, S, seed=0):
    """tokens (or frontend embeds), labels with one masked position, and an
    encoder-decoder's frames, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "embed_stub":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, 0] = -1
    batch["labels"] = labels
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def parity_seq(cfg) -> int:
    """1024 (the reference's kv_block) where causal global attention runs."""
    kinds = set(cfg.block_kinds())
    return 1024 if kinds & {"attn", "mla"} else 64


def models(arch, seed=0):
    jcfg = jshapes.reduced_config(arch)
    cfg = shapes.reduced_config(arch)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    model = Model.from_params(cfg, lm_params_from_jax(cfg, _np(params)),
                              device="cpu")
    return jm, params, model


def torch_grads(model, batch, remat):
    """(loss, gradient tree) of ``model.loss_fn`` through backward()."""
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    loss = model.loss_fn({k: torch.tensor(v) for k, v in batch.items()},
                         remat=remat)
    loss.backward()
    grads = tree_map(lambda p: p.grad.clone() if p.grad is not None
                     else torch.zeros_like(p), model.tree())
    model.requires_grad_(False)
    return float(loss), grads


def check_loss_and_grads(arch):
    jm, params, model = models(arch)
    batch = lm_batch(model.cfg, 1, parity_seq(model.cfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, remat=False)))(params)
    want_g = lm_params_from_jax(model.cfg, _np(want_g))
    got_l, got_g = torch_grads(model, batch, remat=False)
    assert abs(got_l - float(want_l)) <= REL_LOSS * abs(float(want_l))
    for g, w in zip(tree_leaves(got_g), tree_leaves(want_g), strict=True):
        assert g.shape == w.shape
        assert _rel(g, w) < REL_GRAD
