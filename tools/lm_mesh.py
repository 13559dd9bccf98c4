"""DeepSeek-V2-236B served and trained at published width on a mesh of
every visible card (up to four): ``chip_smoke.py``'s ``[lm-mesh]`` and
``[lm-mesh-train]`` phases, and how deep a cut the cards hold.

    python3 tools/lm_mesh.py                      # the [lm-mesh] phase
    python3 tools/lm_mesh.py --depth 26 28 30     # bf16 runs at (1, N)
    python3 tools/lm_mesh.py --depth 4 --mesh 2 2  # bf16 runs at (2, 2)
    python3 tools/lm_mesh.py --train              # [lm-mesh-train] runs
    python3 tools/lm_mesh.py --train --train-runs parity   # only those
    python3 tools/lm_mesh.py --train-depth 1 2 3  # DeepSeek-V2 training cuts
    python3 tools/lm_mesh.py --dp                 # the [lm-mesh-dp] phase
    python3 tools/lm_mesh.py --recurrent --whisper  # the split runs
    python3 tools/lm_mesh.py --recurrent --float64 --archs xlstm-350m
    python3 tools/lm_mesh.py --pairs build/pr25/src  # step times in turns

``--recurrent`` and ``--whisper`` run ``chip_smoke.lm_mesh_split_runs``
on every visible card: RecurrentGemma-2B and xLSTM-350M at published
width, 4 layers, on each mesh ((1, 4) and (2, 2) on four cards; (1, 1) on
one), reduced xLSTM with 2 and 3 heads of 16 at (1, N), where heads
straddle ranks (``--recurrent``); Whisper-small at published width, 2
decoder and 2 encoder layers, under the default rules and with the
vocabulary replicated (``--whisper``).  Each is served at float32 (2 x
512 prompt, 8 decode steps) against the no-mesh run on card 0 (bound
1e-4 of max|logit|), then one decode step profiled and the next one's
collective bytes counted, and trained two steps (remat "dots", 8 x 128
tokens in 2 microbatches) against no mesh on each card (loss rel 1e-5,
every parameter and moment leaf rel 1e-4), one more step profiled and
the next counted.  Every run is printed before the failed gates raise.
``--float64`` runs the same model code and AdamW's moments in float64
(``tools/float64_witness.py``): a gap that is float32 rounding shrinks by
orders of magnitude there, a fault does not.  It first trains each
training run's config without a mesh on card 0 in float32 and in float64
and prints the three leaves where float32 lands farthest from float64 (a
second witness: float32's own distance from the float64 values).
``--archs`` keeps the runs of the archs it names.

``--pairs SRC`` times a Qwen3-4B training step (published width, 4
layers, float32, remat off, 8 x 128 tokens in 2 microbatches: the
config, batch and AdamW of ``chip_smoke``'s training parity runs) on a
(2, N/2) mesh for two source trees in turns: ``SRC`` (a ``git archive`` of
another commit's ``src/``, unpacked under ``build/``) and this tree's
``src/``.  Each tree runs in its own set of NCCL ranks, both sets resident
on the cards; after two warm-up steps each set takes one timed step when
this process says, ten times, parent then change in even rounds and
change then parent in odd ones.  A step is timed on the host clock
between barriers and synchronizes (its slowest rank); the medians, minima
and maxima per tree are printed last.

``--dp`` runs ``chip_smoke.phase_lm_mesh_dp`` on every visible card (up
to four): DP-SGD on a mesh, at (1, 4) and (2, 2) on four cards, and
Qwen3-4B at published width and full depth trained by
``train_loop(dp=..., mesh=(1, 4))``.

``--train`` on four cards: Qwen3-4B at published width and full depth
(36 layers) trained by ``train_loop(mesh=)`` at (1, 4) with the launcher's
remat off, then the same step timed and profiled; DeepSeek-V2 at 4 of 60
layers (bf16, int8 moments, capacity factor 1.25) at (1, 4) and (2, 2),
two steps and one profiled; Qwen3-4B (4 of 36 layers, float32 compute)
against the no-mesh step at (1, 4) and (2, 2), remat "dots" and off, each
profiled.  A profiled step prints each rank's device and NCCL ms, and the
step after it each rank's collective bytes (``OpStats``).
``--train-runs`` keeps the runs of the kinds it names (``loop``: the
full-depth Qwen3-4B, ``moe``: DeepSeek-V2, ``parity``: the 4-layer
Qwen3-4B).  On one card it runs the smoke's (1, 1) runs.  ``--train-depth`` trains
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
from float64_witness import float64_model, plain_rounding_gap  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, nargs="*", default=None,
                    help="layer counts for bf16-only runs on a (1, N) mesh")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"),
                    help="the mesh of the --depth runs (default 1 x cards)")
    ap.add_argument("--train", action="store_true",
                    help="the [lm-mesh-train] runs on every visible card")
    ap.add_argument("--train-runs", nargs="+", default=["loop", "moe", "parity"],
                    choices=["loop", "moe", "parity"],
                    help="the kinds of --train run to make (default all)")
    ap.add_argument("--train-depth", type=int, nargs="*", default=None,
                    help="layer counts of DeepSeek-V2 training runs at (1, N)")
    ap.add_argument("--dp", action="store_true",
                    help="the [lm-mesh-dp] phase on every visible card")
    ap.add_argument("--recurrent", action="store_true",
                    help="the recurrent split runs on every visible card")
    ap.add_argument("--whisper", action="store_true",
                    help="Whisper-small's split runs on every visible card")
    ap.add_argument("--float64", action="store_true",
                    help="the split runs' model code in float64")
    ap.add_argument("--archs", nargs="+", default=None,
                    help="keep the split runs of these archs only")
    ap.add_argument("--pairs", metavar="SRC", default=None,
                    help="time a (2, N/2) training step of the tree at SRC "
                         "against this tree's, in turns")
    ap.add_argument("--pair-rank", nargs=5, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.pair_rank:
        return pair_rank(*args.pair_rank)
    if not torch.cuda.is_available():
        raise SystemExit("tools/lm_mesh.py needs a CUDA device")
    os.chdir(ROOT)
    card = chip_smoke.card_line()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    world = min(torch.cuda.device_count(), 4)
    if args.dp:
        return chip_smoke.phase_lm_mesh_dp(card, world)
    if args.pairs:
        return pairs(world, args.pairs)
    if args.recurrent or args.whisper:
        return split(world, [k for k in ("recurrent", "whisper")
                             if getattr(args, k)], args.float64, args.archs)
    if args.train:
        return train(world, args.train_runs)
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


def train(world, kinds=("loop", "moe", "parity")):
    """The [lm-mesh-train] runs of ``kinds`` on ``world`` cards (the
    smoke's on one)."""
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
                                      remats=["dots", "off"], profile=True)
                 for shape in meshes]
    runs = [r for r in runs if r["kind"] in kinds]
    report = cs.lm_mesh_spawn({"runs": runs, "build": "build"}, world,
                              "train", target=cs._lm_mesh_train_rank,
                              timeout=1800)
    cs.lm_mesh_train_print(report)
    print(f"[lm-mesh-train] world {world}: {time.perf_counter() - t0:.1f} s "
          f"in all")


def split(world, which, float64=False, archs=None):
    """The split runs of ``which`` on ``world`` cards (in float64, after
    the no-mesh witness; of ``archs`` only)."""
    cs = chip_smoke
    t0 = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    runs = [dict(r, float64=float64) for r in cs.lm_mesh_split_runs(world, which)
            if archs is None or r["arch"] in archs]
    if float64:
        witness([r for r in runs if r["kind"] == "parity"])
    report = cs.lm_mesh_spawn({"runs": runs, "build": "build"}, world,
                              "split", target=_float64_rank if float64
                              else cs._lm_mesh_train_rank, timeout=1800)
    cs.lm_mesh_train_print(report)
    print(f"[lm-mesh split] {', '.join(which)} on world {world}: "
          f"{time.perf_counter() - t0:.1f} s in all")


def _float64_rank(*args):
    """``chip_smoke._lm_mesh_train_rank`` with the model code in float64."""
    with float64_model():
        chip_smoke._lm_mesh_train_rank(*args)


def witness(runs):
    """Each config of the training runs ``runs`` trained without a mesh on
    card 0 in float32 against float64: the loss rel and the three leaves
    where float32 lands farthest from float64."""
    seen = set()
    for r in runs:
        key = (r["arch"], r["layers"], r.get("reduced"), r.get("heads"))
        if key in seen:
            continue
        seen.add(key)
        loss, rel = plain_rounding_gap(r)
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
        what = (f"reduced, {r['heads']} heads" if r.get("heads") else
                "reduced" if r.get("reduced") else f"{r['layers']} layers")
        print(f"[lm-mesh witness] {r['arch']} {what}, no mesh on card 0, "
              f"float32 against float64 ({chip_smoke.LM_MESH_TRAIN_STEPS} "
              f"steps, the parity runs' batch and AdamW): loss rel "
              f"{loss:.3e}; farthest leaves "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst)
              + f"; m/embed {rel.get('m/embed', float('nan')):.3e}",
              flush=True)
        chip_smoke.free_device_memory()


PAIR_ARCH, PAIR_LAYERS, PAIR_ROUNDS = "qwen3-4b", 4, 10


def _wait_for(path, procs, timeout=900):
    """Wait until ``path`` exists; raise if a process in ``procs`` died."""
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if any(p.poll() not in (None, 0) for p in procs):
            raise AssertionError(f"[lm-mesh pairs] a rank failed: "
                                 f"{[p.poll() for p in procs]}")
        if time.time() > deadline:
            raise AssertionError(f"[lm-mesh pairs] no {path} in {timeout} s")
        time.sleep(0.005)


def pairs(world, parent_src):
    """The step of ``--pairs`` for the tree at ``parent_src`` and this one,
    in turns (module docstring)."""
    import json
    import shutil
    import statistics
    if world % 2:
        raise SystemExit("--pairs needs an even number of cards")
    ctl = os.path.join("build", f"pairs_{os.getpid()}")
    shutil.rmtree(ctl, ignore_errors=True)
    os.makedirs(ctl)
    trees = {"parent": os.path.abspath(parent_src),
             "change": os.path.join(ROOT, "src")}
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo")
    procs = []
    try:
        for tag, src in trees.items():
            store = os.path.join(ctl, f"store_{tag}")
            procs += [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--pair-rank",
                 src, str(r), str(world), store, tag], env=env)
                for r in range(world)]
        for tag in trees:
            _wait_for(os.path.join(ctl, f"ready_{tag}"), procs)
        times = {tag: [] for tag in trees}
        for i in range(PAIR_ROUNDS):
            order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
            for tag in order:
                open(os.path.join(ctl, f"go_{tag}_{i}"), "w").close()
                done = os.path.join(ctl, f"done_{tag}_{i}")
                _wait_for(done, procs)
                with open(done) as f:
                    times[tag].append(json.load(f))
            print(f"[lm-mesh pairs] round {i}: "
                  + ", ".join(f"{t} {times[t][-1]['s']:.4f} s" for t in order))
        for p in procs:
            p.wait(timeout=300)
        if any(p.returncode for p in procs):
            raise AssertionError(f"[lm-mesh pairs] ranks failed: "
                                 f"{[p.returncode for p in procs]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(ctl, ignore_errors=True)
    out = {}
    for tag, ts in times.items():
        secs = [t["s"] for t in ts]
        out[tag] = {"median_s": statistics.median(secs), "min_s": min(secs),
                    "max_s": max(secs), "s": secs,
                    "losses": [t["loss"] for t in ts]}
    print(f"[lm-mesh pairs] {PAIR_ARCH} {PAIR_LAYERS} layers float32 train "
          f"step at (2, {world // 2}), {PAIR_ROUNDS} rounds in turns:")
    print(json.dumps(out))


def pair_rank(src, rank, world, store, tag):
    """One NCCL rank of ``--pairs`` for the tree at ``src`` (first on the
    path, so ``chip_smoke``'s helpers build that tree's model): two warm-up
    steps, then one timed step each time the coordinating process writes
    ``go_{tag}_{i}``."""
    import json
    sys.path.insert(0, src)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_step import init_train_state
    cs = chip_smoke
    rank, world = int(rank), int(world)
    ctl = os.path.dirname(store)
    cs.nccl_rank(rank, world, store, 900)
    try:
        cfg = cs.lm_mesh_config(PAIR_LAYERS, "float32", arch=PAIR_ARCH)
        mesh = make_host_mesh("cuda", (2, world // 2))
        model = Model.init(cfg, cs.cuda_gen(), mesh=mesh)
        oc = AdamWConfig(**cs.LM_ADAMW)
        state = init_train_state(model, oc)
        step = make_train_step(model, oc, microbatches=2, remat=False)
        batch = cs.lm_mesh_train_batch(cfg)
        for _ in range(2):
            state, met = step(state, batch)
            float(met["loss"])
        torch.cuda.synchronize()
        dist.barrier()
        if rank == 0:
            open(os.path.join(ctl, f"ready_{tag}"), "w").close()
        for i in range(PAIR_ROUNDS):
            while not os.path.exists(os.path.join(ctl, f"go_{tag}_{i}")):
                time.sleep(0.005)
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            loss = float(met["loss"])
            torch.cuda.synchronize()
            secs = torch.tensor([time.perf_counter() - t0], device="cuda")
            dist.all_reduce(secs, op=dist.ReduceOp.MAX)
            if rank == 0:
                with open(os.path.join(ctl, f"done_{tag}_{i}.tmp"), "w") as f:
                    json.dump({"s": float(secs), "loss": loss}, f)
                os.replace(os.path.join(ctl, f"done_{tag}_{i}.tmp"),
                           os.path.join(ctl, f"done_{tag}_{i}"))
    finally:
        dist.destroy_process_group()


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
