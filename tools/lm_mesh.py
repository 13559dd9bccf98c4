"""DeepSeek-V2-236B served and trained at published width on a mesh of
every visible card (up to four): ``chip_smoke.py``'s ``[lm-mesh]`` and
``[lm-mesh-train]`` phases, and how deep a cut the cards hold.

    python3 tools/lm_mesh.py                      # the [lm-mesh] phase
    python3 tools/lm_mesh.py --depth 26 28 30     # bf16 runs at (1, N)
    python3 tools/lm_mesh.py --depth 4 --mesh 2 2  # bf16 runs at (2, 2)
    python3 tools/lm_mesh.py --train              # [lm-mesh-train] runs
    python3 tools/lm_mesh.py --train-depth 1 2 3  # DeepSeek-V2 training cuts

``--train`` on four cards: Qwen3-4B at published width and full depth
(36 layers) trained by ``train_loop(mesh=)`` at (1, 4) with the launcher's
remat off, then the same step timed and profiled; DeepSeek-V2 at 4 of 60
layers (bf16, int8 moments, capacity factor 1.25) at (1, 4) and (2, 2),
two steps and one profiled; Qwen3-4B (4 of 36 layers, float32 compute)
against the no-mesh step at (1, 4) and (2, 2), remat "dots" and off.  On
one card it runs the smoke's (1, 1) runs.  ``--train-depth`` trains
DeepSeek-V2 (bf16, int8 moments) two steps at each depth on a (1, N) mesh
and prints each rank's peak memory; a depth is held when the peak leaves a
fifth of the card free.

Without ``--depth`` it runs ``chip_smoke.phase_lm_mesh`` as the smoke does
(on four cards: DeepSeek-V2 at (1, 4) and (2, 2), parity against the
no-mesh run on card 0, then the bf16 numbers; Qwen3-4B's parity in both
attention modes on each mesh).  With ``--depth`` it runs, for each depth,
only the bf16 serving run on a (1, N) mesh, or on the mesh ``--mesh``
names (2 prompts of 512 tokens, 8 decode steps, capacity factor 1.25),
and prints each rank's peak device memory beside the card's; a depth is
held when the peak leaves a fifth of the card free.  Needs CUDA; prints
every card's name and power limit first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, nargs="*", default=None,
                    help="layer counts for bf16-only runs on a (1, N) mesh")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"),
                    help="the mesh of the --depth runs (default 1 x cards)")
    ap.add_argument("--train", action="store_true",
                    help="the [lm-mesh-train] runs on every visible card")
    ap.add_argument("--train-depth", type=int, nargs="*", default=None,
                    help="layer counts of DeepSeek-V2 training runs at (1, N)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/lm_mesh.py needs a CUDA device")
    os.chdir(ROOT)
    card = chip_smoke.card_line()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    world = min(torch.cuda.device_count(), 4)
    if args.train:
        return train(world)
    if args.train_depth:
        return train_depth(world, args.train_depth)
    if not args.depth:
        chip_smoke.phase_lm_mesh(card)
        return
    shape = tuple(args.mesh) if args.mesh else (1, world)
    if shape[0] * shape[1] != world:
        raise SystemExit(f"--mesh {shape} needs {shape[0] * shape[1]} cards; "
                         f"{world} are visible")
    held = None
    for layers in args.depth:
        job = {"refs": {}, "runs": [chip_smoke.lm_mesh_run(
            chip_smoke.LM_MESH_ARCH, shape, layers, (), True)]}
        report = chip_smoke.lm_mesh_spawn(job, world, f"depth{layers}")
        chip_smoke.lm_mesh_print(report)
        b = report["runs"][0]["bf16"]
        share = max(b["peak_gib"]) / b["card_gib"]
        ok = share <= 0.8
        print(f"[lm-mesh depth] {layers} layers on {shape}: peak "
              f"{max(b['peak_gib']):.3f} GiB of {b['card_gib']:.1f} GiB "
              f"({share:.1%}); {'held' if ok else 'not held'} with a fifth "
              f"free")
        if ok:
            held = layers
    print(f"[lm-mesh depth] deepest cut held with a fifth of each card free: "
          f"{held} layers")


def train(world):
    """The [lm-mesh-train] runs on ``world`` cards (the smoke's on one)."""
    cs = chip_smoke
    t0 = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    if world == 1:
        runs = cs.lm_mesh_train_one_card_runs()
    else:
        meshes = cs.lm_mesh_meshes(world)
        runs = [cs.lm_mesh_train_run("loop", cs.LM_MESH_GQA, (1, world), 36)]
        runs += [cs.lm_mesh_train_run("moe", cs.LM_MESH_ARCH, shape,
                                      cs.LM_MESH_LAYERS, profile=True)
                 for shape in meshes]
        runs += [cs.lm_mesh_train_run("parity", cs.LM_MESH_GQA, shape,
                                      cs.LM_MESH_GQA_LAYERS,
                                      remats=["dots", "off"])
                 for shape in meshes]
    report = cs.lm_mesh_spawn({"runs": runs, "build": "build"}, world,
                              "train", target=cs._lm_mesh_train_rank,
                              timeout=1800)
    cs.lm_mesh_train_print(report)
    print(f"[lm-mesh-train] world {world}: {time.perf_counter() - t0:.1f} s "
          f"in all")


def train_depth(world, depths):
    """DeepSeek-V2 training (bf16, int8 moments) at each depth on a (1, N)
    mesh: each rank's peak memory against a fifth of the card free."""
    cs = chip_smoke
    held = None
    for layers in depths:
        job = {"runs": [cs.lm_mesh_train_run("moe", cs.LM_MESH_ARCH,
                                             (1, world), layers)],
               "build": "build"}
        try:
            report = cs.lm_mesh_spawn(job, world, f"tdepth{layers}",
                                      target=cs._lm_mesh_train_rank)
        except AssertionError as e:      # a rank ran out of memory
            print(f"[lm-mesh-train depth] {layers} layers on (1, {world}): "
                  f"failed ({e})")
            continue
        cs.lm_mesh_train_print(report)
        ranks = report["runs"][0]["ranks"]
        peak = max(r["peak_gib"] for r in ranks)
        share = peak / ranks[0]["card_gib"]
        ok = share <= 0.8
        print(f"[lm-mesh-train depth] {layers} layers on (1, {world}): peak "
              f"{peak:.3f} GiB of {ranks[0]['card_gib']:.1f} GiB ({share:.1%});"
              f" {'held' if ok else 'not held'} with a fifth free")
        if ok:
            held = layers
    print(f"[lm-mesh-train depth] deepest cut held with a fifth of each card "
          f"free: {held} layers")


if __name__ == "__main__":
    main()
