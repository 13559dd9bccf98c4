"""Multi-pod dry run on fake tensors: the port of ``repro.launch.dryrun``.

For each (arch x shape x mesh) cell this module starts a ``"fake"``
process group of 256 (one pod, 16 x 16) or 512 (two pods, 2 x 16 x 16)
ranks in which this process is rank 0, builds the production mesh and the
model at its published widths with every parameter, optimizer moment,
cache and input a DTensor over ``FakeTensorMode`` tensors (shapes and
dtypes, no storage), and runs the cell's real step once: ``make_train_step``
for the train shape, ``prefill`` or ``decode_step`` for the serving shapes,
each under the reference's per-shape sharding rules (:func:`shape_rules`).
:class:`~repro_torch.roofline.op_stats.OpStats` counts what rank 0 runs:
matrix-product FLOPs, bytes and collectives per device.  Nothing is
allocated and nothing runs on a card; the counts are what one rank of the
mesh would execute, and :mod:`repro_torch.roofline.analyze` scores them
with a device row (datasheet rates, not measured times).

    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape decode_32k --mesh single
    python -m repro_torch.launch.dryrun --all [--jobs N]   (one process per
        cell, N at a time; one pod and two pods unless --mesh names one)

Each cell writes ``artifacts/dryrun_torch/{arch}__{shape}__{mesh}.json``
with ``run_cell``'s fields.  Where the reference has no counterpart:
``lower_s``/``compile_s`` become ``trace_s`` (the seconds the fake step
took; the per-token loops of RG-LRU and sLSTM are counted from a few steps,
exactly, as ``hlo_stats`` scales a loop body by its trip count:
:func:`~repro_torch.models.loops.token_loop`), counted warm after a
one-group step (``warmup_s``, :func:`count_step`); ``cost_analysis`` and
``hlo_chars`` are not written; ``--save-hlo`` is left out (there is no HLO; ``op_stats`` holds the counts).  The memory
entries: ``argument_size_in_bytes`` is this rank's shard of every input
(the batch rows the rules give it), ``output_size_in_bytes`` its share of
every output, and ``temp_size_in_bytes`` the peak of the bytes the step
allocated and held at once less what it still holds at its end
(``OpStats``' ``peak_bytes - live_bytes``).  ``torch.distributed._tools.
mem_tracker.MemTracker`` is not used: it hooks every parameter's gradient,
which a serving step's parameters do not have.

The fake tensors sit on ``--device`` (``cuda`` by default).  A PyTorch
built without CUDA cannot index a fake CUDA tensor (its Python indexing
takes a CUDA device guard), so there the default is ``cpu``, and the
record says which; the counts depend on shapes and dtypes only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, load_all
from repro_torch.configs.shapes import (SHAPES, TRAIN_MICROBATCHES,
                                        cell_is_applicable)
from repro_torch.models.config import ModelConfig, get_config, torch_dtype
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.sharding import (DEFAULT_RULES, batch_rows, is_dtensor,
                                         param_spec, place, sharding_rules)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")


def default_device() -> str:
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def shape_rules(shape: str, cfg: ModelConfig):
    """Per-shape logical-rule overrides, the reference's: ``long_500k``
    replicates its batch of one and the heads and splits the cache length
    over (``data``, ``model``); a vocabulary that the model axis does not
    divide (Whisper's 51,865) is replicated."""
    rules = dict(DEFAULT_RULES)
    if shape == "long_500k":
        rules["batch"] = None
        rules["kv_seq"] = ("data", "model")
        rules["heads"] = None
    if cfg.vocab_size % 16 != 0:
        rules["vocab"] = None
    return rules


def _pick_microbatches(target: int, global_batch: int, batch_shards: int) -> int:
    m = min(target, global_batch)
    while m > 1 and (global_batch // m) % batch_shards != 0:
        m //= 2
    return max(m, 1)


def start_fake_group(world: int):
    """This process as rank 0 of a ``"fake"`` process group of ``world``
    ranks, whose collectives return at once (the outputs are fake)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _fake_tree(defs_tree, mesh, dtype_of, device):
    """A DTensor over an empty fake tensor for every PDef leaf, placed by
    its logical axes under the active rules."""
    return tree_map(lambda pd: place(torch.empty(pd.shape, dtype=dtype_of(pd),
                                                 device=device),
                                     mesh, param_spec(mesh, pd.axes).placements),
                    defs_tree)


def _local_bytes(tree, mesh, B=None) -> int:
    """This rank's bytes of ``tree``: a DTensor's local shard; a plain
    input led by the batch axis, the rows ``batch_rows`` gives this rank;
    another plain tensor whole."""
    total = 0
    for x in tree_leaves(tree):
        if not isinstance(x, torch.Tensor):
            continue
        if is_dtensor(x):
            x = x.to_local()
            total += x.numel() * x.element_size()
        elif B is not None and x.dim() and x.shape[0] == B:
            b0, b1 = batch_rows(mesh, B)
            total += x.numel() // B * (b1 - b0) * x.element_size()
        else:
            total += x.numel() * x.element_size()
    return total


def fake_inputs(cfg: ModelConfig, kind: str, B: int, S: int, device: str):
    """The model inputs of a (``kind``, B, S) step as fake tensors of the
    shapes and dtypes ``configs.shapes.input_specs`` gives (``tokens`` (B,
    1) for a decode step)."""
    i32, emb = torch.int32, torch.bfloat16
    if kind == "decode":
        return {"tokens": torch.zeros((B, 1), dtype=i32, device=device)}
    out = {}
    if cfg.frontend == "embed_stub":
        out["embeds"] = torch.zeros((B, S, cfg.d_model), dtype=emb, device=device)
    else:
        out["tokens"] = torch.zeros((B, S), dtype=i32, device=device)
    if kind == "train":
        out["labels"] = torch.zeros((B, S), dtype=i32, device=device)
    if cfg.encoder_layers:
        out["enc_embeds"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                        dtype=emb, device=device)
    return out


def build_step(cfg: ModelConfig, kind: str, B: int, S: int, mesh, rules, *,
               microbatches: int = 1, cache_dtype: str = "bfloat16",
               device: str = "cuda"):
    """(run, args, extra): the model of ``cfg`` on fake DTensors over
    ``mesh`` placed by ``rules``, and a no-argument callable running its
    ``kind`` step (``train``: ``make_train_step`` with remat over
    ``microbatches``; ``prefill``; ``decode``: one step at the last slot of
    an S-slot cache).  Call inside a ``FakeTensorMode``."""
    from repro_torch.models.transformer import Model, cache_defs, model_defs
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state
    pdt = torch_dtype(cfg.param_dtype)
    with sharding_rules(mesh, rules):
        params = _fake_tree(model_defs(cfg), mesh, lambda pd: pdt, device)
    model = Model(cfg, params, mesh=mesh)
    batch = fake_inputs(cfg, kind, B, S, device)
    extra = {}
    if kind == "train":
        opt_cfg = AdamWConfig(int8_states=(cfg.param_dtype == "bfloat16"))
        step = make_train_step(model, opt_cfg, microbatches=microbatches,
                               remat=True)
        # the step count stays a host int: the update reads it on the host,
        # which a fake tensor cannot answer
        state = {"params": model.tree(),
                 "opt": dict(init_opt_state(model.tree(), opt_cfg), count=0),
                 "rng": torch.Generator().get_state()}
        extra = {"microbatches": microbatches,
                 "optimizer_int8": opt_cfg.int8_states}
        return (lambda: step(state, batch)), (state, batch), extra
    if kind == "prefill":
        return (lambda: model.prefill(batch)), (params, batch), extra
    cdt = getattr(torch, cache_dtype)

    def fake_caches(t):     # K/V (and c_kv) in the cache dtype, states fp32
        if isinstance(t, list):
            return [fake_caches(g) for g in t]
        return {k: fake_caches(v) if isinstance(v, (dict, list)) else
                _fake_tree(v, mesh, lambda pd, k=k: cdt if k in
                           ("k", "v", "c_kv") else torch.float32, device)
                for k, v in t.items()}
    with sharding_rules(mesh, rules):
        caches = fake_caches(cache_defs(cfg, B, S))
    tokens = batch["tokens"]
    return ((lambda: model.decode_step(tokens, caches, S - 1)),
            (params, tokens, caches), extra)


def one_group(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` cut to one layer group (and at most one tail group and one
    encoder layer): the layers of a group run the same ops at the same
    shapes as every other group's."""
    tail = min(cfg.n_tail, 1)
    return dataclasses.replace(
        cfg, n_layers=len(cfg.pattern) + tail * len(cfg.tail_pattern),
        n_tail=tail, encoder_layers=min(cfg.encoder_layers, 1))


def count_step(cfg: ModelConfig, kind: str, B: int, S: int, mesh, rules, *,
               microbatches: int = 1, cache_dtype: str = "bfloat16",
               device: str = "cuda", sample_loops: bool = True,
               warm: bool = True) -> dict:
    """A record's measured fields for one fake step on ``mesh`` (a mesh of
    a fake process group): ``memory_analysis``, ``op_stats``, the
    collectives, ``trace_s`` and ``warmup_s``.  The per-token loops are
    counted from a few steps (``OpStats(sample_loops=True)``), exactly;
    ``sample_loops`` False runs every step.

    DTensor's first dispatch of an op at a sharding and shape runs the op
    on fake tensors of the global shapes to propagate its sharding, and
    those ops reach the counting mode; later dispatches hit its cache.  So
    with ``warm`` (the default) the step of :func:`one_group` of ``cfg``
    runs first, uncounted: it dispatches every DTensor op the whole step
    does, at the same shapes, for a fraction of its time, and the count
    is then the same as in a process that ran the step before."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.roofline.op_stats import OpStats
    t0 = time.time()
    if warm:
        count_step(one_group(cfg), kind, B, S, mesh, rules,
                   microbatches=microbatches, cache_dtype=cache_dtype,
                   device=device, sample_loops=sample_loops, warm=False)
    warmup_s = time.time() - t0
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        run, args, rec = build_step(cfg, kind, B, S, mesh, rules,
                                    microbatches=microbatches,
                                    cache_dtype=cache_dtype, device=device)
        with sharding_rules(mesh, rules):
            arg_bytes = _local_bytes(args, mesh, B)
            mode = OpStats(sample_loops=sample_loops)
            with mode:
                out = run()
            out_bytes = _local_bytes(out, mesh, B)
    stats = mode.stats()
    rec.update(
        trace_s=round(time.time() - t0, 2), warmup_s=round(warmup_s, 2),
        memory_analysis={
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": max(stats["peak_bytes"] - stats["live_bytes"], 0)},
        collective_bytes_per_device=stats["collective_bytes"],
        collective_counts=stats["collective_counts"], op_stats=stats)
    return rec


def count_real_train_step(cfg: ModelConfig, B: int, S: int, mesh, *,
                          microbatches: int = 1, seed: int = 0) -> dict:
    """``OpStats``' counts of one real ``make_train_step`` step (remat on,
    as :func:`build_step` runs it) of seeded weights on ``mesh``, a mesh of
    a running real process group, under the default rules: what the fake
    step's counts must equal on a fake mesh of the same shape."""
    from repro_torch.models.transformer import Model
    from repro_torch.roofline.op_stats import OpStats
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.train_step import init_train_state
    dev = mesh.device_type
    model = Model.init(cfg, torch.Generator(dev).manual_seed(seed), mesh=mesh)
    opt_cfg = AdamWConfig(int8_states=(cfg.param_dtype == "bfloat16"))
    step = make_train_step(model, opt_cfg, microbatches=microbatches,
                           remat=True)
    state = init_train_state(model, opt_cfg, seed)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev) for k, v in
             fake_inputs(cfg, "train", B, S, "meta").items()}
    mode = OpStats()
    with mode:
        step(state, batch)
    return mode.stats()


def production_mesh(multi_pod: bool, device: str):
    """The production mesh over a running fake group (built outside any
    ``FakeTensorMode``: the mesh holds real rank tensors)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from repro_torch.launch.mesh import make_production_mesh
    with unset_fake_temporarily():
        return make_production_mesh(multi_pod=multi_pod, device=device)


def model_flops(cfg: ModelConfig, shape: str) -> float:
    """MODEL_FLOPS convention: 6·N_active·tokens (train) / 2·N_active·tokens
    (inference); attention flops excluded."""
    sh = SHAPES[shape]
    n_active = cfg.active_params_estimate()
    if sh["kind"] == "train":
        return 6.0 * n_active * sh["global_batch"] * sh["seq_len"]
    if sh["kind"] == "prefill":
        return 2.0 * n_active * sh["global_batch"] * sh["seq_len"]
    return 2.0 * n_active * sh["global_batch"]


def run_cell(arch: str, shape: str, mesh_kind: str,
             cache_dtype: str = "bfloat16", microbatches_override: int = 0,
             device: str | None = None) -> dict:
    """One cell's record (the reference's ``run_cell`` fields, see the
    module docstring)."""
    multi_pod = mesh_kind == "multi"
    device = device or default_device()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "chips": 512 if multi_pod else 256, "cache_dtype": cache_dtype,
           "fake_device": device}
    ok, why = cell_is_applicable(arch, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        cfg, sh = get_config(arch), SHAPES[shape]
        start_fake_group(rec["chips"])
        mesh = production_mesh(multi_pod, device)
        micro = 1
        if sh["kind"] == "train":
            shards = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                               for a in ("pod", "data")
                               if a in mesh.mesh_dim_names)
            micro = _pick_microbatches(
                microbatches_override or TRAIN_MICROBATCHES.get(arch, 4),
                sh["global_batch"], shards)
        rec.update(count_step(cfg, sh["kind"], sh["global_batch"],
                              sh["seq_len"], mesh, shape_rules(shape, cfg),
                              microbatches=micro, cache_dtype=cache_dtype,
                              device=device))
        rec["n_params"] = cfg.n_params_estimate()
        rec["n_active_params"] = cfg.active_params_estimate()
        rec["model_flops"] = model_flops(cfg, shape)
        rec["status"] = "ok"
        print(f"[dryrun] {arch} {shape} {mesh_kind}: OK (trace {rec['trace_s']}s "
              f"after a {rec['warmup_s']}s warm-up)")
        print("  memory_analysis:", rec["memory_analysis"])
        print("  op_stats flops:", rec["op_stats"]["flops"])
    except Exception as e:  # noqa: BLE001 - recorded in the cell
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} {shape} {mesh_kind}: FAILED {rec['error']}")
    return rec


def cell_path(out_dir: str, arch: str, shape: str, mesh: str, suffix: str = ""):
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}{suffix}.json")


def _run_child(args, a: str, s: str, m: str):
    """One cell of ``--all`` in its own process, skipped when its record is
    already ``ok`` or ``skipped``; a child past ``--timeout`` is recorded
    as ``timeout``."""
    path = cell_path(args.out, a, s, m, args.suffix)
    if os.path.exists(path):
        with open(path) as fh:
            if json.load(fh).get("status") in ("ok", "skipped"):
                return
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", a, "--shape", s, "--mesh", m,
           "--out", args.out, "--cache-dtype", args.cache_dtype,
           "--microbatches", str(args.microbatches),
           "--remat-policy", args.remat_policy,
           "--attn-shard", args.attn_shard, "--suffix", args.suffix]
    if args.device:
        cmd += ["--device", args.device]
    try:
        subprocess.run(cmd, timeout=args.timeout, check=False)
    except subprocess.TimeoutExpired:
        with open(path, "w") as f:
            json.dump({"arch": a, "shape": s, "mesh": m, "status": "timeout"}, f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells of --all run at once, one process each")
    ap.add_argument("--cache-dtype", default="bfloat16",
                    choices=["bfloat16", "float8_e4m3fn"])
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--remat-policy", default="dots",
                    choices=["dots", "dots+kv", "nothing"])
    ap.add_argument("--attn-shard", default="seq", choices=["seq", "heads"])
    ap.add_argument("--suffix", default="")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="the fake tensors' device (default: cuda where "
                         "PyTorch is built with CUDA, else cpu)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        meshes = (args.mesh,) if "--mesh" in (argv or sys.argv) else ("single", "multi")
        cells = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in meshes]
        with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
            list(pool.map(lambda c: _run_child(args, *c), cells))
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    load_all()
    from repro_torch.models.layers import set_attn_sharding
    from repro_torch.models.transformer import set_remat_policy
    set_remat_policy(args.remat_policy)
    set_attn_sharding(args.attn_shard)
    rec = run_cell(args.arch, args.shape, args.mesh,
                   cache_dtype=args.cache_dtype,
                   microbatches_override=args.microbatches,
                   device=args.device)
    rec["remat_policy"] = args.remat_policy
    rec["attn_shard"] = args.attn_shard
    with open(cell_path(args.out, args.arch, args.shape, args.mesh,
                        args.suffix), "w") as f:
        json.dump(rec, f, indent=1)
    if dist.is_initialized():
        dist.destroy_process_group()
    return rec


if __name__ == "__main__":
    main()
