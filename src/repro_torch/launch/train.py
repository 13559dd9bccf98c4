"""Training entry point: the train loop with checkpointing, preemption-safe
resume, a straggler watchdog and optional DP-SGD; the port of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --no-reduced --arch xlstm-350m

Runs on CUDA unless ``--device cpu``.  The loop runs without remat, as the
reference's does, so at full width one NVIDIA H100 80GB HBM3 trains the
smaller models only: Qwen3-4B's float32 parameters, gradients and moments
alone take 65.7 GiB, and its saved bf16 weight casts do not fit beside
them.  ``train_loop(..., mesh=)`` trains on a ``DeviceMesh``
(:mod:`repro_torch.launch.mesh`; the caller starts the process group and
every rank calls it alike): the seeded weights are drawn whole and each
rank keeps its shards, every rank runs the same token stream, the model
runs its step in the mesh's sharding context, and rank 0 logs and commits
the checkpoints, which hold the full global arrays.  Four cards train
Qwen3-4B so (``tools/lm_mesh.py --train``), with DP-SGD too
(``dp=``; the accountant is charged once a step on every rank, rank 0
logs).  The command line trains on one device.  Three behaviours differ from the reference on purpose:

* ``--reduced`` can be switched off (``--no-reduced``): the reference
  declares it ``store_true`` with ``default=True``, so its full-config
  branch never runs.
* A periodic checkpoint after step ``it`` is labelled ``it + 1``, the
  number of steps it holds, as the final one is; the reference labels it
  ``it``, so a resume from it repeats step ``it``.
* A resumed run skips the batches the steps before it consumed; the
  reference restarts the token stream, so its resumed steps see the first
  batches again.  With both, a resumed run's losses equal an uninterrupted
  run's bit for bit.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, load_all
from repro_torch.configs.shapes import reduced_config
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.models import Model, get_config
from repro_torch.train import AdamWConfig, DPSGDConfig, make_train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.dp import DPSGDAccountant
from repro_torch.train.train_step import init_train_state


class StragglerWatchdog:
    """Logs steps whose wall time exceeds mean + k·std of the trailing window
    (on a cluster this would feed a reschedule path; here it reports)."""

    def __init__(self, window: int = 20, k: float = 3.0):
        self.times, self.window, self.k = [], window, k
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:-1]
        if len(hist) >= 5:
            mu, sd = np.mean(hist), np.std(hist) + 1e-9
            if dt > mu + self.k * sd:
                self.flagged += 1
                print(f"[watchdog] straggler step: {dt:.3f}s vs μ={mu:.3f}s")
                return True
        return False


def _batch(cfg, b, it: int, batch_size: int, seq_len: int, dev):
    batch = {"tokens": torch.as_tensor(b["tokens"], device=dev),
             "labels": torch.as_tensor(b["labels"], device=dev)}
    if cfg.frontend == "embed_stub":
        gen = torch.Generator(dev).manual_seed(it)
        batch = {"embeds": torch.randn((batch_size, seq_len, cfg.d_model),
                                       generator=gen, device=dev),
                 "labels": batch["labels"]}
    if cfg.encoder_layers:
        batch["enc_embeds"] = torch.zeros(
            (batch_size, cfg.encoder_seq, cfg.d_model), device=dev)
    return batch


def train_loop(cfg, *, steps: int, batch_size: int, seq_len: int,
               ckpt_dir: str | None, resume: bool, dp: DPSGDConfig | None,
               microbatches: int, ckpt_every: int, mesh=None,
               log_every: int = 10, seed: int = 0, device=None,
               accountant: DPSGDAccountant | None = None):
    """Train ``cfg`` from seeded weights for ``steps`` steps (from the
    latest checkpoint with ``resume``); returns (state, this run's losses).
    On ``mesh`` (every rank calling alike) the state's leaves are DTensors
    and the losses are the whole batch's on every rank.  ``ckpt_dir=None``
    trains without checkpoints (a full-width Qwen3-4B state is 53 GB).
    With ``dp`` the accountant (``accountant``, else a new one) is charged
    before each step, so a step its budget refuses raises before it runs."""
    dev = resolve_device(device if mesh is None else mesh.device_type)
    model = Model.init(cfg, torch.Generator(dev).manual_seed(seed),
                       device=dev, mesh=mesh)
    lead = mesh is None or dist.get_rank() == 0   # logs for the mesh
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20,
                          int8_states=(cfg.param_dtype == "bfloat16"))
    step_fn = make_train_step(model, opt_cfg, microbatches=microbatches,
                              dp=dp, remat=False)
    mgr = None if ckpt_dir is None else CheckpointManager(ckpt_dir, keep=3)
    state = init_train_state(model, opt_cfg, seed)
    start = 0
    if resume and mgr is not None and mgr.latest_step() is not None:
        state, manifest = mgr.restore(state)
        start = manifest["step"]
        if lead:
            print(f"[train] resumed from step {start}")
    acct = (accountant or DPSGDAccountant(dp)) if dp else None
    gen = synthetic_lm_batches(cfg.vocab_size, batch_size, seq_len, seed=seed)
    for _ in range(start):           # the batches the earlier steps consumed
        next(gen)
    wd = StragglerWatchdog()
    losses = []
    for it in range(start, steps):
        batch = _batch(cfg, next(gen), it, batch_size, seq_len, dev)
        if acct:
            acct.charge_step()
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        if lead:
            wd.observe(time.time() - t0)
        losses.append(loss)
        if lead and it % log_every == 0:
            msg = f"[train] step {it} loss {loss:.4f}"
            if acct:
                r = acct.report()
                msg += (f" | dp: ρ={r['rho_zcdp']:.4f} "
                        f"ε(δ=1e-6)={r['eps_at_delta_1e-6']:.2f}")
            print(msg, flush=True)
        if mgr and ckpt_every and (it + 1) % ckpt_every == 0 and it + 1 < steps:
            mgr.save(it + 1, state, {"arch": cfg.name, "loss": loss},
                     blocking=False)
    if mgr:
        mgr.save(steps, state, {"arch": cfg.name,
                                "loss": losses[-1] if losses else None})
        mgr.wait()
    return state, losses


def main(argv=None):
    load_all()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=list(ARCH_IDS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the architecture's small test config (--no-reduced: "
                         "its published widths)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--dp-noise", type=float, default=0.0,
                    help="DP-SGD noise multiplier (0 = off)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    dp = DPSGDConfig(noise_multiplier=args.dp_noise) if args.dp_noise else None
    _, losses = train_loop(cfg, steps=args.steps, batch_size=args.batch,
                           seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                           resume=args.resume, dp=dp,
                           microbatches=args.microbatches,
                           ckpt_every=args.ckpt_every, device=args.device)
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} → {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
