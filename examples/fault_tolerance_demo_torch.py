"""Fault tolerance on the PyTorch port: train, "fail", resume from the
latest atomic checkpoint, then restore the checkpoint onto another device;
the counterpart of ``examples/fault_tolerance_demo.py``.

Phase 1 trains the reduced Qwen3-4B and checkpoints every ``--ckpt-every``
steps; phase 2 is a new process's view: it resumes from the latest
checkpoint and trains on; phase 3 restores that checkpoint on the host
(``restore(..., device="cpu")``).  Restoring onto a multi-device mesh, as
the reference's demo does, waits for the port's mesh launcher.  Runs on
CUDA unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/fault_tolerance_demo_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil

import torch

from repro_torch.configs import load_all
from repro_torch.configs.shapes import reduced_config
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.launch.train import train_loop
from repro_torch.models import Model
from repro_torch.train import AdamWConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import init_train_state


def main(argv=None):
    """Returns (phase 1's losses, phase 2's losses, the restored state)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-dir", default="artifacts/ft_demo_ckpt")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--resume-to", type=int, default=45)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    load_all()
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    cfg = reduced_config("qwen3-4b")
    run = dict(batch_size=args.batch, seq_len=args.seq, ckpt_dir=args.ckpt_dir,
               dp=None, microbatches=1, ckpt_every=args.ckpt_every, device=dev)

    print(f"== phase 1: train {args.steps} steps on {dev}, checkpoint every "
          f"{args.ckpt_every} ==")
    _, first = train_loop(cfg, steps=args.steps, resume=False, **run)

    print("\n== simulated failure: process dies; restart with resume ==")
    _, second = train_loop(cfg, steps=args.resume_to, resume=True, **run)
    print(f"resumed and reached loss {second[-1]:.4f}")

    print("\n== restore the checkpoint onto another device (the host) ==")
    model = Model.init(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    state_like = init_train_state(model, AdamWConfig())
    mgr = CheckpointManager(args.ckpt_dir)
    restored, manifest = mgr.restore(state_like, device="cpu")
    print(f"restored step {manifest['step']} (trained on {dev}) onto the "
          f"host: params on {restored['params']['lm_head'].device}")
    print("fault-tolerance demo OK")
    return first, second, restored


if __name__ == "__main__":
    main()
