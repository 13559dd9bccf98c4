"""The float64 witness of a float32 gap: the port's model code and AdamW
run in float64, where float32 rounding shrinks by about 2^29 while a fault
in the code stays as large as it is.

:func:`float64_model` is the context ``tools/lm_mesh.py --float64`` and
``tools/lm_dp_vmap_gap.py --float64`` run their models under.
:func:`plain_rounding_gap` is a second witness that needs one card: the
no-mesh float32 training steps of a ``chip_smoke`` 'parity' run against
the same steps in float64, leaf by leaf, which shows how far float32 by
itself lands from the float64 values on each leaf.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float64_model():
    """Run the port's model code and AdamW in float64: every dtype name but
    ``"bfloat16"`` maps to float64, ``Tensor.float()`` casts to float64, new
    tensors default to float64 and the float moments are float64.  The
    model is float32 at most, as the reference's; this is a witness of the
    float32 runs, not a mode."""
    from repro_torch.models import config, layers, moe, recurrent, transformer
    from repro_torch.train import optimizer
    mods = [m for m in (config, layers, moe, recurrent, transformer)
            if hasattr(m, "torch_dtype")]
    saved = [m.torch_dtype for m in mods]
    to_float, default = torch.Tensor.float, torch.get_default_dtype()
    moments = optimizer.MOMENT_DTYPE
    for m in mods:
        m.torch_dtype = (lambda name: torch.bfloat16 if name == "bfloat16"
                         else torch.float64)
    torch.Tensor.float = lambda self, *a, **k: self.double(*a, **k)
    torch.set_default_dtype(torch.float64)
    optimizer.MOMENT_DTYPE = torch.float64
    try:
        yield
    finally:
        optimizer.MOMENT_DTYPE = moments
        torch.set_default_dtype(default)
        torch.Tensor.float = to_float
        for m, f in zip(mods, saved):
            m.torch_dtype = f


def _plain_steps(spec):
    """The no-mesh steps of chip_smoke's 'parity' run ``spec`` (its config,
    batch, AdamW and remat "dots"): (losses, ``{path: leaf}`` of the
    parameters and moments)."""
    import chip_smoke as cs
    from repro_torch.models import Model, transformer
    from repro_torch.models.layers import tree_paths
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_step import init_train_state
    cfg = cs.lm_mesh_spec_config(spec)
    oc = AdamWConfig(**cs.LM_ADAMW)
    transformer.set_remat_policy("dots")
    model = Model.init(cfg, cs.cuda_gen(), device="cuda")
    state = init_train_state(model, oc)
    step = make_train_step(model, oc, microbatches=2, remat=True)
    batch = cs.lm_mesh_train_batch(cfg)
    losses = []
    for _ in range(cs.LM_MESH_TRAIN_STEPS):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    leaves = tree_paths({"params": state["params"], "m": state["opt"]["m"],
                         "v": state["opt"]["v"]})
    return losses, {k: v.detach() for k, v in leaves.items()}


def plain_rounding_gap(spec):
    """The no-mesh float32 steps of ``spec`` against the same steps in
    float64 (the same float32 draws): (loss rel, ``{leaf: rel}``), a leaf's
    rel its max |difference| over the float64 leaf's max |entry|, as the
    mesh gate reads a leaf."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got_losses, got = _plain_steps(spec)
    with float64_model():
        want_losses, want = _plain_steps(spec)
    rel = {k: float((got[k].double() - w).abs().max()
                    / w.abs().max().clamp_min(1e-300))
           for k, w in want.items()}
    loss = max(abs(a - b) / abs(b) for a, b in zip(got_losses, want_losses))
    return loss, rel
