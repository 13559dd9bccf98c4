"""Fault tolerance on the PyTorch port: train, "fail", resume from the
latest atomic checkpoint, then restore the checkpoint onto another device;
the counterpart of ``examples/fault_tolerance_demo.py``.

Phase 1 trains the reduced Qwen3-4B and checkpoints every ``--ckpt-every``
steps; phase 2 is a new process's view: it resumes from the latest
checkpoint and trains on; phase 3 is the elastic re-mesh, as the
reference's demo has it: the checkpoint, written without a mesh, restored
straight onto ``make_host_mesh()`` (every parameter and moment a
replicated DTensor) over a one-rank process group (NCCL on CUDA, gloo on
the CPU; its ``FileStore`` beside the checkpoint directory), then once
more on the host (``restore(..., device="cpu")``).  Runs on CUDA unless
``--device cpu``.

Run:  PYTHONPATH=src python examples/fault_tolerance_demo_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import datetime
import os
import shutil

import torch
import torch.distributed as dist

from repro_torch.configs import load_all
from repro_torch.configs.shapes import reduced_config
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import train_loop
from repro_torch.models import Model
from repro_torch.models.sharding import spec_for
from repro_torch.train import AdamWConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import init_train_state


def main(argv=None):
    """Returns (phase 1's losses, phase 2's losses, the state restored on
    the host, the state restored on the mesh)."""
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

    print("\n== elastic re-mesh: restore the checkpoint onto a fresh mesh ==")
    model = Model.init(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    state_like = init_train_state(model, AdamWConfig())
    mgr = CheckpointManager(args.ckpt_dir)
    store = os.path.abspath(args.ckpt_dir.rstrip("/") + ".pg_store")
    if os.path.exists(store):
        os.remove(store)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store, 1), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh(dev)
        everywhere = spec_for(mesh)          # replicated, as the reference's
        shardings = {"params": everywhere,
                     "opt": {"m": everywhere, "v": everywhere, "count": None},
                     "rng": None}
        on_mesh, manifest = mgr.restore(state_like, shardings=shardings)
        lm_head = on_mesh["params"]["lm_head"]
        print(f"restored step {manifest['step']} onto mesh "
              f"{tuple(mesh.shape)} {mesh.mesh_dim_names}: lm_head a "
              f"{type(lm_head).__name__} placed {lm_head.placements}")
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    restored, manifest = mgr.restore(state_like, device="cpu")
    print(f"restored step {manifest['step']} (trained on {dev}) onto the "
          f"host: params on {restored['params']['lm_head'].device}")
    print("fault-tolerance demo OK")
    return first, second, restored, on_mesh


if __name__ == "__main__":
    main()
