"""The per-token loop of the port's recurrent mixers
(``repro_torch.models.loops.token_loop``: the RG-LRU prefill and the
sLSTM) against the loop that reads step t as ``x[:, t]``, kept here.

* Gradients: reduced RecurrentGemma-2B and xLSTM-350M's loss and every
  parameter's gradient equal, element for element (``torch.equal``),
  through either loop.
* Bytes: ``OpStats`` over the loop's forward and backward at the reduced
  models' loop shapes (RG-LRU's (B, S, w) coefficients, the sLSTM's
  (B, S, H, 4 dh) pre-activations).  From S = 64 to S = 128 the unbound
  loop's bytes grow at most 2.2x; the indexed loop's grow more than 3x
  (each step's backward writes a zero (B, S, .) gradient: 3.45x for the
  sLSTM, whose per-step work is larger).  The whole loss and
  backward at S = 128 moves less than half the indexed loop's bytes.
"""
import numpy as np
import pytest
import torch

ARCHS = ("recurrentgemma-2b", "xlstm-350m")
B = 2
GROWTH = 2.2


def indexed_loop(step, carry, xs, n, consts=()):
    """``token_loop`` as it read its steps before: ``x[:, t]`` per step."""
    carry, xs, consts = tuple(carry), tuple(xs), tuple(consts)
    ys = []
    for t in range(n):
        carry, y = step(carry, tuple(x[:, t] for x in xs), consts)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def _loss_and_grads(arch, S, loop, monkeypatch):
    from repro_torch.configs import load_all, shapes
    from repro_torch.models import Model, recurrent
    from repro_torch.roofline.op_stats import OpStats
    load_all()
    monkeypatch.setattr(recurrent, "token_loop", loop)
    cfg = shapes.reduced_config(arch)
    model = Model.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    model.requires_grad_(True)
    rng = np.random.default_rng(3)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)))
             for k in ("tokens", "labels")}
    with OpStats() as st:
        loss = model.loss_fn(batch, remat=False)
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss.detach(), grads, st.stats()["bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_unbound_loop_gradients_equal_the_indexed_loop(arch, monkeypatch):
    from repro_torch.models.loops import token_loop
    loss, grads, new_bytes = _loss_and_grads(arch, 128, token_loop, monkeypatch)
    want, want_grads, old_bytes = _loss_and_grads(arch, 128, indexed_loop,
                                                  monkeypatch)
    assert torch.equal(loss, want)
    assert grads.keys() == want_grads.keys()
    for k, g in grads.items():
        assert (g is None) == (want_grads[k] is None), k
        if g is not None:
            assert torch.equal(g, want_grads[k]), k
    assert new_bytes < 0.5 * old_bytes, (new_bytes, old_bytes)


def _loop_problem(arch, S):
    """(step, carry, xs, consts) of the arch's looping mixer at the reduced
    config's widths, seeded, every tensor requiring a gradient."""
    from repro_torch.configs import load_all, shapes
    from repro_torch.models import recurrent
    load_all()
    cfg = shapes.reduced_config(arch)
    g = torch.Generator().manual_seed(5)

    def leaf(*shape):
        return torch.rand(*shape, generator=g).requires_grad_(True)

    if arch == "recurrentgemma-2b":
        w = cfg.rnn_state_dim or cfg.d_model
        return recurrent._rglru_step, (leaf(B, w),), \
            (leaf(B, S, w), leaf(B, S, w)), ()
    H, dh = cfg.n_heads, cfg.head_dim
    carry = (leaf(B, H, dh), leaf(B, H, dh) + 1.0, leaf(B, H, dh),
             leaf(B, H, dh))
    return recurrent._slstm_step, carry, (leaf(B, S, H, 4 * dh),), \
        (leaf(H, dh, 4 * dh),)


def _loop_bytes(arch, S, loop):
    from repro_torch.roofline.op_stats import OpStats
    step, carry, xs, consts = _loop_problem(arch, S)
    with OpStats() as st:
        carry, ys = loop(step, carry, xs, S, consts)
        (ys.sum() + sum(c.sum() for c in carry)).backward()
    return st.stats()["bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loop_bytes_grow_linearly_in_the_sequence(arch):
    from repro_torch.models.loops import token_loop
    new = [_loop_bytes(arch, S, token_loop) for S in (64, 128)]
    old = [_loop_bytes(arch, S, indexed_loop) for S in (64, 128)]
    assert 0 < new[1] <= GROWTH * new[0], new
    assert old[1] > 3 * old[0], old
    assert new[1] < old[1]
