"""DeepSeek-V2-236B served at published width on a mesh of every visible
card (up to four): ``chip_smoke.py``'s ``[lm-mesh]`` phase, and how deep a
cut the cards hold.

    python3 tools/lm_mesh.py                      # the [lm-mesh] phase
    python3 tools/lm_mesh.py --depth 26 28 30     # bf16 runs at (1, N)
    python3 tools/lm_mesh.py --depth 4 --mesh 2 2  # bf16 runs at (2, 2)

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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tools/lm_mesh.py needs a CUDA device")
    os.chdir(ROOT)
    card = chip_smoke.card_line()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    if not args.depth:
        chip_smoke.phase_lm_mesh(card)
        return
    world = min(torch.cuda.device_count(), 4)
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


if __name__ == "__main__":
    main()
