"""DP-SGD in the PyTorch port against the JAX package's ``repro.train.dp``.

Reduced Qwen3-4B (and xLSTM-350M and Kimi-K2 for the per-example loop),
float32 on the CPU, seeded with numpy.

* ``per_example_clipped_grad`` equals the reference's (rel 1e-5 of each
  leaf's max) at S = 1024 (``tests/_lm_train_parity.py``), equals a loop
  of single-example clipped gradients (rel 1e-5), and its norm is at most
  C.  The DP path runs without remat (``torch.func.grad`` refuses the
  checkpoint's saved-tensor hooks); a one-example DP gradient with the
  clip off equals the remat path's gradient (rel 1e-6).
* Noise: ``add_dp_noise``'s moments against C·σ/B and 0, for both
  packages (within 5 standard errors); never bits (ROADMAP parity rule 1).
* The accountant's report equals the reference's; a step the budget
  refuses is counted by the reference (its fault) and not by the port.
* A DP train step fed the same noise tree in both packages (the noise
  functions replaced by one adding a seeded numpy tree) gives the
  reference's parameters and moments (rel 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import dp as jdp
from repro.train import optimizer as jopt
from repro.train import train_step as jstep
from repro_torch.configs.shapes import reduced_config
from repro_torch.convert import lm_params_from_jax, train_state_from_jax
from repro_torch.models import Model
from repro_torch.train import AdamWConfig, make_train_step, train_step as tstep
from repro_torch.train.dp import (DPSGDAccountant, DPSGDConfig, add_dp_noise,
                                  per_example_clipped_grad)
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train.train_step import functional_loss, init_train_state

from _lm_train_parity import _np, _rel, lm_batch, models

REL_DP = 1e-5      # clipped means, of each leaf's max
REL_REMAT = 1e-6   # the no-remat DP gradient against the remat path's


def _clipped_loop(model, batch, clip):
    """Mean of single-example gradients, each clipped to ``clip``."""
    loss = functional_loss(model)
    grads = []
    for i in range(next(iter(batch.values())).shape[0]):
        ex = {k: v[i:i + 1] for k, v in batch.items()}
        g = torch.func.grad(loss)(model.tree(), ex)
        n = torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree_leaves(g)))
        s = min(1.0, clip / max(float(n), 1e-12))
        grads.append([x * s for x in tree_leaves(g)])
    return [sum(gs) / len(grads) for gs in zip(*grads)]


def test_per_example_clipped_grad_matches_reference():
    jm, params, model = models("qwen3-4b")
    batch = lm_batch(model.cfg, 3, 1024, seed=4)
    C = 0.1
    want = jax.jit(lambda p, b: jdp.per_example_clipped_grad(
        lambda q, e: jm.loss_fn(q, e, remat=False), p, b, C))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = lm_params_from_jax(model.cfg, _np(want))
    got = per_example_clipped_grad(
        functional_loss(model), model.tree(),
        {k: torch.tensor(v) for k, v in batch.items()}, C)
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert tuple(g.shape) == w.shape
        assert _rel(g, w) < REL_DP


@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-350m", "kimi-k2-1t-a32b"])
def test_vmap_equals_per_example_loop_and_clips(arch):
    cfg = reduced_config(arch)
    model = Model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.tensor(v) for k, v in lm_batch(cfg, 4, 16, seed=5).items()}
    C = 0.1
    got = tree_leaves(per_example_clipped_grad(functional_loss(model),
                                               model.tree(), batch, C))
    want = _clipped_loop(model, batch, C)
    for g, w in zip(got, want, strict=True):
        assert _rel(g, w) < REL_DP
    norm = float(torch.sqrt(sum(torch.sum(g ** 2) for g in got)))
    assert norm <= C + 1e-6           # a mean of <= C-norm vectors


def test_clipped_grad_of_a_training_model_records_no_graph():
    """With the model's gradients on (as make_train_step leaves them) the
    per-example computation must not be recorded for a second derivative:
    that graph holds every intermediate and ran a full-width xLSTM-350M
    DP step out of device memory."""
    cfg = reduced_config("qwen3-4b")
    model = Model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    model.requires_grad_(True)
    batch = {k: torch.tensor(v) for k, v in lm_batch(cfg, 2, 16, seed=5).items()}
    got = per_example_clipped_grad(functional_loss(model), model.tree(), batch, 0.1)
    assert all(g.grad_fn is None and not g.requires_grad for g in tree_leaves(got))


def test_dp_gradient_without_remat_equals_the_remat_path():
    cfg = reduced_config("qwen3-4b")
    model = Model.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    batch = {k: torch.tensor(v) for k, v in lm_batch(cfg, 1, 16, seed=6).items()}
    got = per_example_clipped_grad(functional_loss(model), model.tree(), batch,
                                   1e9)
    model.requires_grad_(True)
    model.loss_fn(batch, remat=True).backward()
    for g, p in zip(tree_leaves(got), tree_leaves(model.tree()), strict=True):
        assert _rel(g, p.grad) < REL_REMAT


def test_noise_moments_in_both_packages():
    """std C·σ/B and mean 0 within 5 standard errors over 2.5e5 entries, for
    the port's draws and for the reference's."""
    C, sigma, B = 1.0, 1.3, 8
    shapes_ = {"a": (300, 400), "b": [(500, 100), (7,)], "c": (80_000,)}
    is_shape = lambda s: isinstance(s, tuple)   # noqa: E731
    zeros_np = jax.tree_util.tree_map(lambda s: np.zeros(s, np.float32), shapes_,
                                      is_leaf=is_shape)
    mine = add_dp_noise(tree_map(torch.tensor, zeros_np),
                        torch.Generator().manual_seed(0), C, sigma, B)
    ref = jdp.add_dp_noise(jax.tree_util.tree_map(jnp.asarray, zeros_np),
                           jax.random.PRNGKey(0), C, sigma, B)
    want = C * sigma / B
    for flat in (torch.cat([x.reshape(-1) for x in tree_leaves(mine)]).numpy(),
                 np.concatenate([np.asarray(x).reshape(-1)
                                 for x in jax.tree_util.tree_leaves(ref)])):
        n = flat.size
        assert n == 250_007
        assert abs(flat.mean()) < 5 * want / np.sqrt(n)
        assert abs(flat.std() - want) < 5 * want / np.sqrt(2 * n)
    # one draw per leaf, each of its own values
    a, b = tree_leaves(mine)[:2]
    assert not torch.equal(a.reshape(-1)[:100], b.reshape(-1)[:100])


def test_accountant_report_matches_reference():
    for sigma, steps in ((2.0, 100), (1.0, 3), (0.7, 17)):
        mine = DPSGDAccountant(DPSGDConfig(clip_norm=1.0, noise_multiplier=sigma))
        ref = jdp.DPSGDAccountant(jdp.DPSGDConfig(clip_norm=1.0,
                                                  noise_multiplier=sigma))
        for _ in range(steps):
            mine.charge_step()
            ref.charge_step()
        got, want = mine.report(), ref.report()
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


def test_accountant_counts_only_funded_steps():
    """Reference fault: its charge_step counts the step before the budget
    charges it, so a refused step stays in the report.  The port counts a
    step once it is paid for."""
    from repro.core.accountant import BudgetExhausted as JBudgetExhausted
    from repro.core.accountant import PrivacyBudget as JPrivacyBudget
    from repro_torch.core.accountant import BudgetExhausted, PrivacyBudget
    for make, refused, acct_cls, cfg_cls in (
            (JPrivacyBudget, JBudgetExhausted, jdp.DPSGDAccountant,
             jdp.DPSGDConfig),
            (PrivacyBudget, BudgetExhausted, DPSGDAccountant, DPSGDConfig)):
        budget = make(4.0)
        budget.charge(1.0)                      # a release spends 1
        acct = acct_cls(cfg_cls(noise_multiplier=1.0), budget)
        funded = 0
        with pytest.raises(refused):
            while True:
                acct.charge_step()
                funded += 1
        assert funded == 3 and budget.spent == 4.0
        want = 4 if acct_cls is jdp.DPSGDAccountant else 3
        assert acct.report()["steps"] == want
        assert acct.report()["pcost"] == float(want)


def test_dp_step_fed_the_same_noise_matches_reference(monkeypatch):
    """One DP step (2 microbatches, C 0.5, σ 1) from the reference's initial
    state; both packages add the same seeded numpy noise tree (eps 1e-4:
    see tests/test_torch_train.py)."""
    jm, params, model = models("qwen3-4b", seed=2)
    cfg_kw = dict(lr=1e-3, warmup_steps=2, eps=1e-4)
    dpc = dict(clip_norm=0.5, noise_multiplier=1.0)
    batch = lm_batch(model.cfg, 2, 1024, seed=7)
    rng = np.random.default_rng(8)
    noise = jax.tree_util.tree_map(
        lambda p: (0.25 * rng.standard_normal(p.shape)).astype(np.float32),
        _np(params))
    monkeypatch.setattr(jstep, "add_dp_noise", lambda g, key, *a: jax.tree_util.tree_map(
        lambda x, n: x + jnp.asarray(n), g, noise))
    jstate = {"params": params, "opt": jopt.init_opt_state(
        params, jopt.AdamWConfig(**cfg_kw)), "rng": jax.random.PRNGKey(0)}
    want, wm = jax.jit(jstep.make_train_step(
        jm, jopt.AdamWConfig(**cfg_kw), microbatches=2,
        dp=jdp.DPSGDConfig(**dpc)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnoise = tree_map(torch.tensor, lm_params_from_jax(model.cfg, noise))
    monkeypatch.setattr(tstep, "add_dp_noise", lambda g, gen, *a: tree_map(
        lambda x, n: x + n, g, tnoise))
    step = make_train_step(model, AdamWConfig(**cfg_kw), microbatches=2,
                           dp=DPSGDConfig(**dpc))
    got, gm = step(init_train_state(model, AdamWConfig(**cfg_kw)), batch)
    assert abs(float(gm["loss"]) - float(wm["loss"])) <= REL_DP * float(wm["loss"])
    want = train_state_from_jax(model.cfg, _np(want))
    for part in ("params", "opt"):
        for g, w in zip(tree_leaves(got[part]), tree_leaves(want[part]),
                        strict=True):
            assert _rel(g.detach(), w) < REL_DP, part


def test_dp_step_draws_from_the_state_generator():
    """The state's rng is the generator's state: a step from one state
    draws the same noise twice, and the next state's rng has moved."""
    cfg = reduced_config("qwen3-4b")
    batch = lm_batch(cfg, 2, 16, seed=9)
    out = []
    for _ in range(2):
        model = Model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        oc = AdamWConfig()
        state = init_train_state(model, oc, seed=3)
        step = make_train_step(model, oc, microbatches=2, dp=DPSGDConfig())
        new, _ = step(state, batch)
        out.append((tree_leaves(new["params"]), new["rng"], state["rng"]))
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(out[0][1], out[1][1])
    assert not torch.equal(out[0][1], out[0][2])
