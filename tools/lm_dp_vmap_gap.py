#!/usr/bin/env python3
"""How far DP-SGD's vmap clipped mean sits from a per-example loop, by depth.

    python3 tools/lm_dp_vmap_gap.py [--layers 24 8 2] [--float64]
                                                  # needs one CUDA card

xLSTM-350M at its published widths, seeded weights, float32 compute with
TF32 off, one batch of 8 x 128 synthetic tokens, clip 1: for each depth
the vmap clipped mean of 8 examples against (1) a loop of 8 single-example
clipped gradients and (2) 4 vmaps of 2 examples each, as max |difference|
over the largest |gradient| entry (global) and the worst leaf's own
ratio.  (2) is the same function at another batch shape, so it measures
the float32 rounding floor that (1) sits on; but it goes through vmap
too.  ``--float64`` runs the same model code in float64
(``tools/float64_witness.py``): rounding then shrinks by about 2^29, while a
fault in vmap's batching would stay as large as it is.  Prints the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from float64_witness import float64_model  # noqa: E402


def _gaps(got, want):
    gmax = max(float(w.abs().max()) for w in want)
    diff = [float((a - w).abs().max()) for a, w in zip(got, want)]
    leaf = max(d / max(float(w.abs().max()), 1e-30) for d, w in zip(diff, want))
    return max(diff) / gmax, leaf


def gaps(cfg, device: str, batch):
    """(vmap against the loop, vmap(B) against B/2 x vmap(2)), each as
    (of max|g|, worst leaf), for ``cfg`` on ``batch`` with clip 1; and the
    gradients' dtype."""
    import chip_smoke as cs
    from repro_torch.models import Model
    from repro_torch.train.dp import per_example_clipped_grad
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.train_step import functional_loss
    model = Model.init(cfg, torch.Generator(device).manual_seed(cs.SEED),
                       device=device)
    loss = functional_loss(model)
    got = tree_leaves(per_example_clipped_grad(loss, model.tree(), batch, 1.0))
    loop = cs.clipped_loop(model, batch, 1.0)
    B = next(iter(batch.values())).shape[0]
    parts = [tree_leaves(per_example_clipped_grad(
        loss, model.tree(), {k: v[i:i + 2] for k, v in batch.items()}, 1.0))
        for i in range(0, B, 2)]
    pairs = [sum(p[j] for p in parts) / len(parts) for j in range(len(got))]
    return _gaps(got, loop), _gaps(got, pairs), got[0].dtype


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[24, 8, 2])
    ap.add_argument("--float64", action="store_true",
                    help="run the model code in float64 (float64_model)")
    args = ap.parse_args(argv)
    import chip_smoke as cs
    from repro_torch.configs import load_all
    from repro_torch.models import get_config
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    load_all()
    print(f"[card] {cs.card_line()}")
    for n in args.layers:
        cfg = dataclasses.replace(get_config("xlstm-350m"), n_layers=n,
                                  compute_dtype="float32")
        with float64_model() if args.float64 else contextlib.nullcontext():
            (g1, l1), (g2, l2), dtype = gaps(cfg, "cuda", cs.lm_train_batch(cfg))
        print(f"[lm_dp_vmap_gap] {n} layers ({str(dtype).split('.')[-1]} "
              f"gradients): vmap(8) against the loop "
              f"{g1:.3e} of max|g| (worst leaf {l1:.3e}); against 4 x vmap(2) "
              f"{g2:.3e} (worst leaf {l2:.3e})", flush=True)
        torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
