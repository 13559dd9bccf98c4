"""The LM training path of the PyTorch port against the JAX package's.

Float32 on the CPU, seeded with numpy; weights drawn by the JAX package's
``Model.init`` and carried across with ``repro_torch.convert``.

* int8 moments: ``quantize_i8`` gives the reference's q exactly and its
  scales within 1 ulp; ``apply_updates`` over 5 steps, float32 and int8
  moments, within rel 1e-6 of each leaf's max (one rounding per operation
  in the reference's order).
* ``Model.loss_fn`` and its gradients against the reference's on all ten
  architectures: ``tests/test_torch_train_grads.py`` and
  ``tests/test_torch_train_grads_rnn_encdec.py`` (``tests/_lm_train_parity.py``).
* The remat policies and ``remat=False`` give the same loss and gradients
  bit for bit; "nothing" recomputes the forward's products in the backward
  pass, "dots" and "dots+kv" do not.
* One ``make_train_step`` step of 2 microbatches against the reference's,
  state carried by ``train_state_from_jax``, rel 1e-5 (int8 moments
  within one quantization step); a 30-step run's
  loss falls, as ``tests/test_train.py::test_train_loss_decreases``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import load_all as jax_load_all
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro_torch.configs import load_all
from repro_torch.configs import shapes
from repro_torch.convert import train_state_from_jax
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.models import Model
from repro_torch.models import transformer
from repro_torch.train import (AdamWConfig, apply_updates, init_opt_state,
                               make_train_step)
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train.optimizer import dequantize_i8, quantize_i8
from repro_torch.train.train_step import init_train_state

from _lm_train_parity import _np, _rel, lm_batch, models

jax_load_all()
load_all()

REL_OPT = 1e-6     # apply_updates, 5 steps
REL_STEP = 1e-5    # one train step, each parameter and moment leaf


def test_quantize_i8_matches_reference():
    rng = np.random.default_rng(0)
    for shape in [(4, 256), (3, 5, 128), (7,), (2, 100), (64, 384)]:
        x = rng.standard_normal(shape).astype(np.float32)
        wq, ws = jopt.quantize_i8(jnp.asarray(x))
        q, s = quantize_i8(torch.tensor(x))
        assert q.dtype == torch.int8 and q.shape == shape
        assert np.array_equal(q.numpy(), np.asarray(wq))
        ws = np.asarray(ws)
        assert np.all(np.abs(s.numpy() - ws) <= np.spacing(ws))
        back = dequantize_i8(q, s).numpy()
        assert np.max(np.abs(back - x)) <= np.abs(x).max() / 127.0 + 1e-7


@pytest.mark.parametrize("int8", [False, True])
def test_apply_updates_matches_reference(int8):
    """Five steps on one tree (nested dicts, a vector, a last axis that is
    not a multiple of 128), gradient clipping active."""
    rng = np.random.default_rng(1)
    shapes_ = {"a": (8, 256), "b": {"c": (3, 5, 128), "d": (7,)}, "e": (2, 100)}

    def draw():
        return jax.tree_util.tree_map(
            lambda s: rng.standard_normal(s).astype(np.float32), shapes_,
            is_leaf=lambda s: isinstance(s, tuple))

    p0, grads = draw(), [draw() for _ in range(5)]
    kw = dict(lr=1e-2, warmup_steps=3, int8_states=int8)
    jcfg, cfg = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jopt.init_opt_state(jp, jcfg)
    tp = tree_map(torch.tensor, p0)
    ts = init_opt_state(tp, cfg)
    for g in grads:
        jp, js, jm = jopt.apply_updates(jp, jax.tree_util.tree_map(jnp.asarray, g),
                                        js, jcfg)
        tp, ts, tm = apply_updates(tp, tree_map(torch.tensor, g), ts, cfg)
    assert float(tm["grad_norm"]) > 1.0          # the clip was active
    assert abs(float(tm["lr"]) - float(jm["lr"])) == 0.0
    assert int(ts["count"]) == int(js["count"]) == 5
    for got, want in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                         strict=True):
        assert _rel(got, want) < REL_OPT
    for name in ("m", "v"):
        got = tree_leaves(ts[name])
        want = jax.tree_util.tree_leaves(js[name])
        for a, b in zip(got, want, strict=True):
            assert a.dtype == (torch.int8 if b.dtype == jnp.int8 else torch.float32)
            assert _rel(a, b) < REL_OPT


class _CountMM(TorchDispatchMode):
    """Counts the ``aten.mm`` calls that run (a remat policy's saved
    outputs are returned by the checkpoint's own mode and never get here)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _mm_calls_in_backward(model, batch, remat):
    model.zero_grad(set_to_none=True)
    loss = model.loss_fn(batch, remat=remat)
    count = _CountMM()
    with count:
        loss.backward()
    return float(loss), count.n


@pytest.mark.parametrize("arch", ["qwen3-4b", "kimi-k2-1t-a32b", "whisper-small"])
def test_remat_policies_give_equal_loss_and_grads(arch):
    cfg = shapes.reduced_config(arch)
    model = Model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    model.requires_grad_(True)
    batch = {k: torch.tensor(v) for k, v in lm_batch(cfg, 2, 16).items()}
    runs = {}
    try:
        for name in ("nothing", "dots", "dots+kv"):
            transformer.set_remat_policy(name)
            loss, mm = _mm_calls_in_backward(model, batch, True)
            runs[name] = (loss, mm, [p.grad.clone() for p in model.parameters()])
    finally:
        transformer.set_remat_policy("dots")
    loss, mm, _ = runs["plain"] = (*_mm_calls_in_backward(model, batch, False),
                                   [p.grad.clone() for p in model.parameters()])
    for name, (l, _, grads) in runs.items():
        assert l == runs["plain"][0], name
        for g, w in zip(grads, runs["plain"][2]):
            assert torch.equal(g, w), name
    # "nothing" recomputes every forward product in the backward pass; the
    # "dots" policies keep them, as a run without remat does
    assert runs["dots"][1] == runs["dots+kv"][1] == runs["plain"][1]
    assert runs["nothing"][1] > runs["plain"][1]


def _jax_state_np(jm, params, jcfg):
    return _np({"params": params, "opt": jopt.init_opt_state(params, jcfg)})


@pytest.mark.parametrize("int8", [False, True])
def test_train_step_matches_reference(int8):
    """One step of 2 microbatches from the reference's initial state,
    carried by train_state_from_jax (float32 or int8 moments).

    eps = 1e-4: Adam's first update g/(|g| + eps) amplifies a gradient's
    rounding by up to 1/eps, and at the default 1e-8 an entry whose
    gradient sits at the float32 noise of the sums (about 1e-7 of max|g|)
    moves by up to lr; at 1e-4 the amplification is at most 1e4.  The
    moments, linear in the gradient, are compared as well."""
    arch = "qwen3-4b"
    jm, params, model = models(arch)
    kw = dict(lr=1e-3, warmup_steps=2, eps=1e-4, int8_states=int8)
    jcfg, cfg = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    jstate = {"params": params, "opt": jopt.init_opt_state(params, jcfg),
              "rng": jax.random.PRNGKey(0)}
    batch = lm_batch(model.cfg, 2, 1024, seed=3)
    batch["labels"][1, 5:9] = -1
    want, wm = jax.jit(jstep.make_train_step(jm, jcfg, microbatches=2,
                                             remat=True))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    conv = train_state_from_jax(model.cfg, _np(jstate))
    step = make_train_step(model, cfg, microbatches=2, remat=True)
    state = init_train_state(model, cfg)
    state["opt"] = tree_map(torch.tensor, conv["opt"])
    got, gm = step(state, batch)
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= REL_STEP * float(wm["loss"])
    assert abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) \
        <= REL_STEP * float(wm["grad_norm"])
    assert int(got["opt"]["count"]) == 1
    want = train_state_from_jax(model.cfg, _np(want))
    for part in ("params", "opt"):
        for g, w in zip(tree_leaves(got[part]), tree_leaves(want[part]),
                        strict=True):
            assert tuple(g.shape) == w.shape
            if g.dtype == torch.int8:
                # a moment at a rounding boundary may round the other way
                # when the gradient differs in its last bits
                assert np.abs(g.numpy().astype(int) - w.astype(int)).max() <= 1
            else:
                assert _rel(g.detach(), w) < REL_STEP, part


def test_train_state_from_jax_keeps_int8_moments():
    jm, params, model = models("xlstm-350m")
    jcfg = jopt.AdamWConfig(int8_states=True)
    conv = train_state_from_jax(model.cfg, _jax_state_np(jm, params, jcfg))
    mine = init_train_state(model, AdamWConfig(int8_states=True))
    assert set(conv) == {"params", "opt"}
    for a, b in zip(tree_leaves(conv["opt"]["m"]), tree_leaves(mine["opt"]["m"]),
                    strict=True):
        assert a.shape == tuple(b.shape) and str(a.dtype) == str(b.dtype)[6:]
    assert int(conv["opt"]["count"]) == 0


def test_train_loss_decreases():
    """tests/test_train.py::test_train_loss_decreases on the port."""
    cfg = shapes.reduced_config("qwen3-4b")
    model = Model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    oc = AdamWConfig(lr=3e-3, warmup_steps=5)
    state = init_train_state(model, oc)
    step = make_train_step(model, oc, microbatches=2, remat=False)
    b0 = next(synthetic_lm_batches(cfg.vocab_size, batch=8, seq_len=16, seed=0))
    batch = {"tokens": b0["tokens"], "labels": b0["labels"]}
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, losses[::10]
