"""The port's dry run (``repro_torch.launch.dryrun``) and its roofline
readers (``repro_torch.roofline.op_stats``, ``.analyze``) on the CPU,
against the JAX package's ``hlo_stats`` and dry run.

* ``OpStats`` counts FLOPs as ``tests/test_roofline.py`` checks
  ``hlo_stats``: a 64x128 by 128x256 product exactly (its bytes all the
  ``mm``'s in ``bytes_by_op``), a loop of 17 steps 17 times, nested loops
  of 3 and 5 steps 15 times (eager loops run every step, so the counts
  are exact).
* The mesh regions take their axes from the active rules: at (2, 2) on
  four gloo ranks, under ``long_500k``'s rules (batch replicated, the
  cache length over (``data``, ``model``)) reduced Qwen3-4B and
  RecurrentGemma-2B prefill and decode, and under ``vocab`` None reduced
  Whisper-small's prefill, decode and loss and gradients, equal the
  no-mesh model within rel 1e-5 (gradients 1e-4 of each leaf's max, as
  ``tests/test_torch_mesh_train.py``).
* Against ``hlo_stats``: reduced configs on a fake (2, 2) mesh against the
  reference's compiled step on a (2, 2) mesh of four forced host devices,
  fifteen cases (Qwen3-4B, DeepSeek-V2, RecurrentGemma-2B, xLSTM-350M and
  Whisper-small, prefill, decode and train; Whisper's prefill and train
  take its encoder frames on both sides).  The mixers, Whisper's encoder
  and cross attention among them, split their projections over ``model``
  as XLA splits the reference's from its rules, so the port's per-device
  dot FLOPs are never fewer than the reference's and at most rel 0.05
  more in serving, 0.10 in training.  Measured: Qwen3-4B,
  RecurrentGemma-2B, xLSTM-350M and Whisper-small equal the reference in
  all three but xLSTM-350M's train case, 1.0003; DeepSeek-V2 prefill and
  decode equal it too (MLA's latent c_kv by rows over ``model``), held
  exactly, once the reference is charged the expert work its
  data-axis fault leaves out (its MoE keeps each rank's tokens but splits
  each expert's d_ff over ``data``; the port gathers the tokens over
  ``data``, so its router, experts and shared expert run on twice the
  tokens: :func:`_moe_flops` counts both from the reference's capacity
  formulas).  DeepSeek-V2's train case is compared without that
  correction and reads 1.0749: the MoE's doubled work through the forward
  and backward, and the remat saveable sets ("dots" in both, different
  sets saved).  The per-device
  ``argument_size_in_bytes`` equals the reference's ``memory_analysis``
  once the scalar bookkeeping is set aside: the reference's decode ``pos``
  (4 bytes; its ``jit`` drops it where no attention reads it, xLSTM) and
  train ``count`` and key (12 bytes), the port's generator state in the
  train state, and the parameters an encoder-decoder's decode step never
  reads (the encoder, the cross attention's ``wk`` and ``wv``), which the
  reference's ``jit`` prunes.
* On a fake (1, 4) decode of reduced Qwen3-4B, RecurrentGemma-2B and
  Whisper-small, what ``OpStats`` counts as all-gathered is at most the
  step's projected activations (each layer's (B, 1, ·) q/k/v or RG-LRU
  input, its cross attention's q, and the logits), fewer bytes than the
  ``qkv`` and ``rnn_state`` weights: no such weight is gathered over
  ``model``.
* Loop sampling: reduced RecurrentGemma-2B and xLSTM-350M prefill and
  train at S = 64 on a fake (2, 2) mesh count the same FLOPs, bytes and
  collectives (by kind), and the same bytes op by op, with
  ``OpStats(sample_loops=True)`` as with every step run; sampling on real
  tensors raises.
* Warm counts: two ``count_step`` counts of one fake (2, 2) step in a
  fresh process are equal in FLOPs, bytes and collectives (its one-group
  warm-up keeps DTensor's first dispatch out); with ``warm=False`` the
  first count reads more bytes.
* Fake against real: reduced Qwen3-4B's train step counted on a fake
  (1, 4) and (2, 2) mesh gives the FLOPs and collective counts the same
  counters give on the real gloo run of that step, exactly.
* A production cell at 256 fake ranks (``qwen3-4b decode_32k single``)
  reaches ``ok`` in a subprocess within 120 s; a skipped cell carries the
  reference's reason; ``analyze_cell`` on the record gives positive terms
  and a bottleneck.
* ``examples/cell_fairness_torch.py``, run once: its variance ranges and
  spreads equal those of the reference's planner within rel 1e-9, and it
  imports neither jax nor ``repro``.
"""
import datetime
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_mesh import _draw, _rel, flatten, unflatten
from test_torch_mesh_train import _full, _load, make_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
REL_GRAD = 1e-4
LONG_RULES = {"batch": None, "kv_seq": ("data", "model"), "heads": None}
VOCAB_RULES = {"vocab": None}
# name -> (arch, rules)
RULE_CASES = {"long-qwen3-4b": ("qwen3-4b", LONG_RULES),
              "long-recurrentgemma-2b": ("recurrentgemma-2b", LONG_RULES),
              "vocab-whisper-small": ("whisper-small", VOCAB_RULES)}
B_RULES, S_RULES, EXTRA = 2, 16, 4
# (arch, kind) at (2, 2): B, S
COUNT_ARCHS = ("qwen3-4b", "deepseek-v2-236b", "recurrentgemma-2b",
               "xlstm-350m", "whisper-small")
COUNT_CASES = {(a, k): (4, 64) for a in COUNT_ARCHS
               for k in ("prefill", "decode", "train")}
REL_FLOPS = {"prefill": 0.05, "decode": 0.05, "train": 0.10}
# cases held tighter, at their measured ratio: MLA's latent by rows
REL_FLOPS_CASE = {("deepseek-v2-236b", "prefill"): 0.0,
                  ("deepseek-v2-236b", "decode"): 0.0}
COUNT_MESH = (2, 2)          # (data, model)
# the reference's scalar arguments the port passes on the host or not at all
REF_SCALARS = {"prefill": 0, "decode": 4, "train": 12}
ATTN_KINDS = ("attn", "attn_local", "mla")
PRODUCTION_S = 120
REAL_SHAPES = ((1, 4), (2, 2))
REAL_STEP = (4, 32)          # B, S of the fake-against-real train step


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

def test_op_stats_counts_dot_flops():
    from repro_torch.roofline.op_stats import op_stats
    a, b = torch.zeros(64, 128), torch.zeros(128, 256)
    _, st = op_stats(lambda: a @ b)
    assert st["flops"] == 2 * 64 * 128 * 256
    assert st["bytes"] == 4 * (64 * 128 + 128 * 256 + 64 * 256)
    assert st["bytes_by_op"] == {"aten.mm": st["bytes"]}


def test_op_stats_counts_every_loop_step():
    from repro_torch.roofline.op_stats import op_stats
    a = torch.zeros(64, 64)

    def f(x):
        for _ in range(17):
            x = x @ a
        return x

    assert op_stats(f, a)[1]["flops"] == 17 * 2 * 64 ** 3


def test_op_stats_nested_loops():
    from repro_torch.roofline.op_stats import op_stats
    a = torch.zeros(32, 32)

    def f(x):
        for _ in range(3):
            for _ in range(5):
                x = torch.einsum("ij,jk->ik", x, a)
        return x

    assert op_stats(f, a)[1]["flops"] == 15 * 2 * 32 ** 3


# ---------------------------------------------------------------------------
# The rules: four gloo ranks against the no-mesh model
# ---------------------------------------------------------------------------

def _rules_rank(rank, world, store_path, wdir, out):
    import torch.distributed as dist
    from repro_torch.configs import load_all, shapes
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_paths
    from repro_torch.models.sharding import sharding_rules
    from repro_torch.train.optimizer import placed_like
    torch.set_num_threads(1)
    load_all()
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh("cpu", (2, 2))
        for name, (arch, rules) in RULE_CASES.items():
            cfg = shapes.reduced_config(arch)
            w = unflatten(_load(f"{wdir}/{name}.npz"))
            batch = {k: torch.tensor(v)
                     for k, v in _load(f"{wdir}/batch-{name}.npz").items()}
            model = Model.from_params(cfg, lm_params_from_jax(cfg, w, mesh=mesh),
                                      mesh=mesh)
            got = {}
            with sharding_rules(mesh, rules):
                inputs = {k: v for k, v in batch.items() if k != "labels"}
                logits, caches = model.prefill(inputs, cache_len=S_RULES + EXTRA)
                got["prefill"] = _full(logits)
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                logits, _ = model.decode_step(tok, caches, S_RULES)
                got["decode"] = _full(logits)
                if rules is VOCAB_RULES:
                    model.requires_grad_(True)
                    loss = model.loss_fn(batch, remat=False, aux_weight=0.0)
                    loss.backward()
                    got["loss"] = float(loss.detach())
                    for k, p in tree_paths(model.tree()).items():
                        g = torch.zeros_like(p) if p.grad is None \
                            else placed_like(p.grad, p)
                        got[f"grad/{k}"] = _full(g)
            if rank == 0:
                np.savez(f"{out}/{name}.npz", **got)
        # the counters on a real step, for the fake one to equal
        from repro_torch.launch.dryrun import count_real_train_step
        for shape in REAL_SHAPES:
            st = count_real_train_step(
                shapes.reduced_config("qwen3-4b"), *REAL_STEP,
                make_host_mesh("cpu", shape), microbatches=2)
            if rank == 0:
                with open(f"{out}/real-{shape[0]}{shape[1]}.json", "w") as f:
                    json.dump(st, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def rule_runs(tmp_path_factory):
    from repro.configs import load_all, shapes
    from repro.models import Model as JaxModel
    load_all()
    base = tmp_path_factory.mktemp("dryrun_rules")
    wdir, out = base / "weights", base / "port"
    wdir.mkdir()
    out.mkdir()
    for i, (name, (arch, _)) in enumerate(RULE_CASES.items()):
        cfg = shapes.reduced_config(arch)
        np.savez(wdir / f"{name}.npz", **flatten(
            _draw(JaxModel(cfg).param_defs(), np.random.default_rng(80 + i))))
        np.savez(wdir / f"batch-{name}.npz",
                 **make_batch(cfg, B_RULES, S_RULES, seed=80 + i))
    ctx = mp.get_context("spawn")
    ranks = [ctx.Process(target=_rules_rank,
                         args=(r, 4, str(base / "store"), str(wdir), str(out)))
             for r in range(4)]
    for p in ranks:
        p.start()
    for p in ranks:
        p.join(timeout=300)
    hung = [p for p in ranks if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(5)
    assert not hung, "a gloo rank did not finish within 300 s"
    assert all(p.exitcode == 0 for p in ranks), [p.exitcode for p in ranks]
    return {"weights": wdir, "port": out}


@pytest.mark.parametrize("name", list(RULE_CASES))
def test_regions_under_dry_run_rules_match_no_mesh(rule_runs, name):
    """Prefill and one decode step (and, under ``vocab`` None, the loss and
    every gradient) at (2, 2) under the dry run's rules against the port
    without a mesh."""
    from repro_torch.configs import load_all, shapes
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_paths
    load_all()
    arch, rules = RULE_CASES[name]
    cfg = shapes.reduced_config(arch)
    w = unflatten(_load(rule_runs["weights"] / f"{name}.npz"))
    model = Model.from_params(cfg, lm_params_from_jax(cfg, w), device="cpu")
    batch = {k: torch.tensor(v)
             for k, v in _load(rule_runs["weights"] / f"batch-{name}.npz").items()}
    got = _load(rule_runs["port"] / f"{name}.npz")
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    logits, caches = model.prefill(inputs, cache_len=S_RULES + EXTRA)
    assert _rel(got["prefill"], logits.numpy()) < REL
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    logits, _ = model.decode_step(tok, caches, S_RULES)
    assert _rel(got["decode"], logits.numpy()) < REL
    if rules is VOCAB_RULES:
        model.requires_grad_(True)
        loss = model.loss_fn(batch, remat=False, aux_weight=0.0)
        loss.backward()
        loss = float(loss.detach())
        assert abs(float(got["loss"]) - loss) <= REL * abs(loss)
        for k, p in tree_paths(model.tree()).items():
            want = np.zeros(p.shape, np.float32) if p.grad is None \
                else p.grad.numpy()
            assert _rel(got[f"grad/{k}"], want) < REL_GRAD, k


@pytest.mark.parametrize("shape", REAL_SHAPES)
def test_fake_step_counts_equal_the_real_step(rule_runs, shape):
    """Reduced Qwen3-4B's train step (2 microbatches, remat): the matrix-
    product FLOPs and the collectives of each kind that ``OpStats`` counts
    on rank 0 of a fake mesh equal those it counts on rank 0 of the real
    gloo run, exactly."""
    import torch.distributed as dist
    from repro_torch.configs import load_all, shapes
    from repro_torch.launch.dryrun import count_step, start_fake_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import DEFAULT_RULES
    load_all()
    with open(rule_runs["port"] / f"real-{shape[0]}{shape[1]}.json") as f:
        real = json.load(f)
    start_fake_group(4)
    try:
        fake = count_step(shapes.reduced_config("qwen3-4b"), "train",
                          *REAL_STEP, make_mesh(shape, ("data", "model"), "cpu"),
                          DEFAULT_RULES, microbatches=2, device="cpu")["op_stats"]
    finally:
        dist.destroy_process_group()
    assert real["flops"] > 0 and fake["flops"] == real["flops"]
    assert fake["collective_counts"] == real["collective_counts"]
    assert sum(real["collective_counts"].values()) > 0


# ---------------------------------------------------------------------------
# Counts against hlo_stats on (2, 2)
# ---------------------------------------------------------------------------

def _reference_counts(out):
    """The reference's per-device dot FLOPs and argument bytes of each
    COUNT_CASES step on a (2, 2) mesh of four forced host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import load_all, shapes
    from repro.models import Model
    from repro.models.sharding import sharding_rules, spec_for
    from repro.models.transformer import cache_axes, cache_shape_structs
    from repro.roofline.hlo_stats import hlo_stats
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import make_train_step
    from repro.launch.dryrun import _axes_to_sharding, _opt_axes_like
    load_all()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(COUNT_MESH),
                ("data", "model"))
    res = {}
    for (arch, kind), (B, S) in COUNT_CASES.items():
        cfg = shapes.reduced_config(arch)
        model = Model(cfg)
        params = model.param_shapes()
        psh = _axes_to_sharding(mesh, model.param_axes())
        tok = jax.ShapeDtypeStruct((B, 1 if kind == "decode" else S), jnp.int32)
        tsh = spec_for(mesh, "batch", None)
        # an encoder-decoder's prefill and train steps also take the
        # encoder's input frames, as the port's fake_inputs gives them
        enc, esh = {}, {}
        if cfg.encoder_layers and kind != "decode":
            enc = {"enc_embeds": jax.ShapeDtypeStruct(
                (B, cfg.encoder_seq, cfg.d_model), jnp.bfloat16)}
            esh = {"enc_embeds": spec_for(mesh, "batch", None, None)}
        with sharding_rules(mesh):
            if kind == "train":
                ocfg = AdamWConfig()
                step = make_train_step(model, ocfg, microbatches=1, remat=True)
                state = {"params": params, "opt": jax.eval_shape(
                    lambda p: init_opt_state(p, ocfg), params),
                    "rng": jax.ShapeDtypeStruct((2,), jnp.uint32)}
                ssh = {"params": psh, "opt": _axes_to_sharding(
                    mesh, _opt_axes_like(model.param_axes(), False)),
                    "rng": NamedSharding(mesh, P())}
                fn = jax.jit(step, in_shardings=(
                    ssh, {"tokens": tsh, "labels": tsh, **esh}),
                    out_shardings=(ssh, None), donate_argnums=(0,))
                args = (state, {"tokens": tok, "labels": tok, **enc})
            elif kind == "prefill":
                fn = jax.jit(lambda p, b: model.prefill(p, b),
                             in_shardings=(psh, {"tokens": tsh, **esh}))
                args = (params, {"tokens": tok, **enc})
            else:
                cs = cache_shape_structs(cfg, B, S, dtype=jnp.bfloat16)
                csh = _axes_to_sharding(mesh, cache_axes(cfg, B, S))
                fn = jax.jit(lambda p, t, c, pos: model.decode_step(p, t, c, pos),
                             in_shardings=(psh, tsh, csh, NamedSharding(mesh, P())),
                             out_shardings=(None, csh), donate_argnums=(2,))
                args = (params, tok, cs, jax.ShapeDtypeStruct((), jnp.int32))
            compiled = fn.lower(*args).compile()
        ma = compiled.memory_analysis()
        res[f"{arch}/{kind}/flops"] = hlo_stats(compiled.as_text())["flops"]
        res[f"{arch}/{kind}/args"] = int(ma.argument_size_in_bytes)
    np.savez(out, **res)


def _port_counts():
    import torch.distributed as dist
    from repro_torch.configs import load_all, shapes
    from repro_torch.launch.dryrun import count_step, start_fake_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import DEFAULT_RULES
    load_all()
    start_fake_group(4)
    try:
        mesh = make_mesh(COUNT_MESH, ("data", "model"), "cpu")
        res = {}
        for (arch, kind), (B, S) in COUNT_CASES.items():
            cfg = shapes.reduced_config(arch)
            rec = count_step(cfg, kind, B, S, mesh, DEFAULT_RULES, device="cpu")
            res[f"{arch}/{kind}/flops"] = rec["op_stats"]["flops"]
            res[f"{arch}/{kind}/args"] = rec["memory_analysis"]["argument_size_in_bytes"]
        return res
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_counts") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    port = _port_counts()
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log.decode()[-3000:]
    return port, _load(out)


def _moe_flops(cfg, kind: str, t: int, data: int, n: int) -> float:
    """Dot FLOPs of one MoE layer on a rank that routes ``t`` tokens with
    ``n`` expert shards and each expert's d_ff split over ``data``, from
    the reference's capacity formulas (``_moe_local`` for a sequence that
    splits over the experts' axis, ``_moe_replicated_local`` for a decode
    step): router, capacity-padded expert buffers, shared expert."""
    mo, d = cfg.moe, cfg.d_model
    e_loc, f_loc = mo.n_experts // n, mo.d_expert // data
    if kind == "decode":
        cap = math.ceil(t * mo.top_k / e_loc * mo.capacity_factor)
    else:
        cap1 = math.ceil(t * mo.top_k / n * mo.capacity_factor)
        cap = math.ceil(n * cap1 / e_loc * mo.capacity_factor)
    return (2 * t * d * mo.n_experts + e_loc * cap * 3 * 2 * d * f_loc
            + 3 * 2 * t * d * mo.n_shared * f_loc)


def _moe_left_out(cfg, kind: str, B: int, S: int) -> float:
    """The expert work per device the reference's data-axis fault leaves
    out of a serving step at COUNT_MESH: the port routes each rank's tokens
    gathered over ``data`` (``data`` times the reference's), the right
    count for experts whose d_ff is split over ``data``."""
    data, n = COUNT_MESH
    if cfg.moe is None or kind == "train" or data == 1:
        return 0.0
    t = B // data * (1 if kind == "decode" else S // n)
    per_layer = _moe_flops(cfg, kind, data * t, data, n) \
        - _moe_flops(cfg, kind, t, data, n)
    return per_layer * len(cfg.block_kinds())


def _unread_in_decode(cfg) -> int:
    """This rank's bytes (float32, at COUNT_MESH under the default rules)
    of the parameters an encoder-decoder's decode step never reads: the
    encoder, its norm, and each cross attention's ``wk`` and ``wv`` (the
    encoder's K/V are cached).  The reference's ``jit`` prunes unused
    arguments, so its ``argument_size_in_bytes`` leaves them out."""
    from repro_torch.models.sharding import DEFAULT_RULES
    from repro_torch.models.transformer import model_defs
    if not cfg.encoder_layers:
        return 0
    size = dict(zip(("data", "model"), COUNT_MESH))

    def local(pd):
        n = 4 * math.prod(pd.shape)
        for a in pd.axes:
            r = DEFAULT_RULES.get(a) if a else None
            for ax in (r,) if isinstance(r, str) else (r or ()):
                n //= size.get(ax, 1)
        return n

    def walk(t):
        return sum(walk(v) for v in (t.values() if isinstance(t, dict) else t)) \
            if isinstance(t, (dict, list)) else local(t)

    d = model_defs(cfg)
    return walk(d["encoder_blocks"]) + walk(d["encoder_norm"]) + sum(
        local(g[k]["attn"][w]) for g in d["blocks"] for k in g
        if k.endswith(":xattn") for w in ("wk", "wv"))


@pytest.mark.parametrize("case", [f"{a}/{k}" for a, k in COUNT_CASES])
def test_op_stats_flops_match_hlo_stats_at_2x2(counts, case):
    from repro_torch.configs import load_all, shapes
    load_all()
    port, ref = counts
    arch, kind = case.split("/")
    cfg = shapes.reduced_config(arch)
    want = float(ref[f"{case}/flops"])
    assert want > 0
    want += _moe_left_out(cfg, kind, *COUNT_CASES[(arch, kind)])
    rel = REL_FLOPS_CASE.get((arch, kind), REL_FLOPS[kind])
    got = port[f"{case}/flops"]
    # the ratio case by case: pytest -s -k flops_match_hlo_stats
    line = f"{case}: port {got:.6g}, reference {want:.6g}, ratio {got / want:.4f}"
    print(line)
    assert want <= got <= (1 + rel) * want, line
    rng = torch.Generator().get_state().numel() if kind == "train" else 0
    # the reference's jit drops a decode ``pos`` that no attention reads
    scalars = REF_SCALARS[kind] if kind != "decode" or any(
        k in ATTN_KINDS for k in cfg.block_kinds()) else 0
    unread = _unread_in_decode(cfg) if kind == "decode" else 0
    assert port[f"{case}/args"] - rng - unread \
        == int(ref[f"{case}/args"]) - scalars


def _activation_bytes(cfg, B: int) -> int:
    """The float32 bytes of a decode step's projected activations: each
    layer's (B, 1, ·) q, k, v (attention) or input u (RG-LRU), its cross
    attention's q in an encoder-decoder, and the logits."""
    per = {"attn": cfg.q_dim + 2 * cfg.kv_dim, "attn_local": cfg.q_dim + 2 * cfg.kv_dim,
           "rglru": cfg.rnn_state_dim or cfg.d_model}
    xq = cfg.q_dim if cfg.encoder_layers else 0
    return 4 * B * (sum(per[k] + xq for k in cfg.block_kinds())
                    + cfg.vocab_size)


@pytest.mark.parametrize("arch", ["qwen3-4b", "recurrentgemma-2b",
                                  "whisper-small"])
def test_decode_gathers_activations_not_weights_at_1x4(arch):
    """A fake (1, 4) decode step: every all-gather is over ``model``, and
    together they move no more than the step's projected activations,
    fewer bytes than the ``qkv`` and ``rnn_state`` weights that a step
    gathering its weights would move."""
    import torch.distributed as dist
    from repro_torch.configs import load_all, shapes
    from repro_torch.launch.dryrun import count_step, start_fake_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import DEFAULT_RULES
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import model_defs
    load_all()
    cfg = shapes.reduced_config(arch)
    B = 4
    start_fake_group(4)
    try:
        st = count_step(cfg, "decode", B, 64, make_mesh((1, 4), ("data", "model"),
                                                        "cpu"),
                        DEFAULT_RULES, device="cpu")["op_stats"]
    finally:
        dist.destroy_process_group()
    weights = []
    tree_map(lambda pd: weights.append(4 * math.prod(pd.shape))
             if len(pd.shape) == 2 and {"qkv", "rnn_state"} & set(pd.axes)
             else None, model_defs(cfg))
    gathered = st["collective_bytes"]["all-gather"]
    assert st["collective_counts"]["all-gather"] > 0
    assert gathered <= _activation_bytes(cfg, B) < sum(weights), \
        (gathered, _activation_bytes(cfg, B), sum(weights))


SAMPLE_CASES = [(a, k) for a in ("recurrentgemma-2b", "xlstm-350m")
                for k in ("prefill", "train")]


@pytest.mark.parametrize("arch,kind", SAMPLE_CASES)
def test_sampled_loops_count_exactly(arch, kind):
    """The per-token loops counted from a few steps equal every step run:
    FLOPs, bytes and each kind of collective, at S = 64 on a fake (2, 2)
    mesh (each count warm: ``count_step`` runs a one-group step first)."""
    import torch.distributed as dist
    from repro_torch.configs import load_all, shapes
    from repro_torch.launch.dryrun import count_step, start_fake_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import DEFAULT_RULES
    load_all()
    cfg = shapes.reduced_config(arch)
    start_fake_group(4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        full, sampled = [count_step(cfg, kind, 4, 64, mesh, DEFAULT_RULES,
                                    device="cpu", sample_loops=s)["op_stats"]
                         for s in (False, True)]
    finally:
        dist.destroy_process_group()
    assert full["flops"] > 0 and sampled["flops"] == full["flops"]
    assert sampled["bytes"] == full["bytes"]
    assert sampled["bytes_by_op"] == full["bytes_by_op"]
    assert sum(full["bytes_by_op"].values()) == full["bytes"]
    assert sampled["collective_bytes"] == full["collective_bytes"]
    assert sampled["collective_counts"] == full["collective_counts"]


WARM_CASES = [("recurrentgemma-2b", "prefill"), ("whisper-small", "train")]
_TWO_COUNTS = """
import json, sys
import torch.distributed as dist
from repro_torch.configs import load_all, shapes
from repro_torch.launch.dryrun import count_step, start_fake_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding import DEFAULT_RULES
load_all()
start_fake_group(4)
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
kw = {} if sys.argv[3] == "default" else {"warm": False}
out = [count_step(shapes.reduced_config(sys.argv[1]), sys.argv[2], 4, 64, mesh,
                  DEFAULT_RULES, device="cpu", **kw)["op_stats"]
       for _ in range(2)]
dist.destroy_process_group()
print(json.dumps(out))
"""


def _two_counts(arch, kind, default):
    """Two ``count_step`` counts of one step in a fresh process: with its
    default ``warm``, or with ``warm=False``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _TWO_COUNTS, arch, kind,
                           "default" if default else "cold"], env=env,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    return json.loads(proc.stdout.decode().strip().splitlines()[-1])


@pytest.mark.parametrize("arch,kind", WARM_CASES)
def test_two_counts_of_a_step_in_a_fresh_process_are_equal(arch, kind):
    """``count_step`` twice on one fake (2, 2) step in a fresh process, the
    caller warming nothing: FLOPs, bytes and each kind of collective are
    equal.  Without its one-group warm-up the first count reads more bytes
    (DTensor's first dispatch of each op propagates its sharding through
    fake ops that reach the counting mode) and the same FLOPs."""
    first, second = _two_counts(arch, kind, default=True)
    assert first["flops"] > 0 and first["flops"] == second["flops"]
    assert first["bytes"] == second["bytes"]
    assert first["collective_bytes"] == second["collective_bytes"]
    assert first["collective_counts"] == second["collective_counts"]
    cold, warm = _two_counts(arch, kind, default=False)
    assert cold["flops"] == warm["flops"] == first["flops"]
    assert cold["bytes"] > warm["bytes"] == first["bytes"]


def test_loop_sampling_on_real_tensors_raises():
    """Sampling stands in for steps it does not run, so it takes fake
    tensors only; an unsampled count runs every step."""
    from repro_torch.models.loops import token_loop
    from repro_torch.roofline.op_stats import OpStats

    def step(c, x, k):
        h = x[0] * c[0] + x[1]
        return (h,), h

    a, b, h0 = torch.rand(2, 9, 3), torch.rand(2, 9, 3), torch.zeros(2, 3)
    with pytest.raises(RuntimeError, match="fake tensors only"):
        with OpStats(sample_loops=True):
            token_loop(step, (h0,), (a, b), 9)
    with OpStats() as st:
        (h,), hs = token_loop(step, (h0,), (a, b), 9)
    assert hs.shape == (2, 9, 3) and st.stats()["bytes"] > 0
    want = h0
    for t in range(9):
        want = a[:, t] * want + b[:, t]
    assert torch.equal(h, want)


# ---------------------------------------------------------------------------
# Production cells, analyze, the example
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def production(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_cell")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", "qwen3-4b", "--shape", "decode_32k",
                           "--mesh", "single", "--out", str(out)],
                          env=env, capture_output=True, timeout=600)
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    with open(out / "qwen3-4b__decode_32k__single.json") as f:
        return json.load(f)


def test_production_cell_at_256_fake_ranks(production):
    rec = production
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 256 and rec["trace_s"] < PRODUCTION_S
    ma = rec["memory_analysis"]
    assert all(ma[k] > 0 for k in ("argument_size_in_bytes",
                                   "output_size_in_bytes", "temp_size_in_bytes"))
    assert rec["op_stats"]["flops"] > 0
    assert rec["collective_counts"]["all-gather"] > 0
    assert rec["n_params"] > 3e9 and rec["model_flops"] > 0


def test_skipped_cell_carries_the_reference_reason():
    from repro.configs import load_all as jload
    from repro.configs.shapes import cell_is_applicable
    from repro_torch.configs import load_all
    from repro_torch.launch.dryrun import run_cell
    jload()
    load_all()
    rec = run_cell("qwen3-4b", "long_500k", "single", device="cpu")
    assert rec["status"] == "skipped"
    assert rec["reason"] == cell_is_applicable("qwen3-4b", "long_500k")[1]


def test_analyze_cell_on_a_port_record(production, tmp_path):
    from repro_torch.roofline.analyze import (analyze_all, analyze_cell,
                                              markdown_table)
    cell = analyze_cell(production)
    assert min(cell.t_compute, cell.t_memory, cell.t_collective) > 0
    assert cell.bottleneck in ("compute", "memory", "collective")
    assert 0 < cell.useful_ratio and 0 < cell.mfu_bound <= 1
    with open(tmp_path / "qwen3-4b__decode_32k__single.json", "w") as f:
        json.dump(production, f)
    table = markdown_table(analyze_all(str(tmp_path)))
    assert "| qwen3-4b | decode_32k |" in table


def test_cell_fairness_example_matches_reference_planner():
    import importlib.util
    from repro.core import all_kway, select_sum_of_variances
    from repro.data.tabular import adult_domain
    path = os.path.join(ROOT, "examples", "cell_fairness_torch.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    code = (f"import runpy, sys; out = runpy.run_path({path!r})['main'](); "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "or m == 'repro' for m in sys.modules), 'imports jax or repro'")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert b"spread across marginals" in proc.stdout
    spec = importlib.util.spec_from_file_location("cell_fairness_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    dom = adult_domain()
    wk = all_kway(dom, 3, include_lower=True)
    for scheme in ex.SCHEMES:
        got = ex.fairness(scheme)
        wks = wk.reweighted(scheme)
        plan = select_sum_of_variances(wks, 1.0, dict(wks.weights))
        by_k = {}
        for c, v in plan.workload_variances().items():
            by_k.setdefault(len(c), []).append(v)
        assert sorted(got["ranges"]) == sorted(by_k)
        for k, vs in by_k.items():
            lo, hi, n = got["ranges"][k]
            assert n == len(vs)
            assert abs(lo - min(vs)) <= 1e-9 * min(vs)
            assert abs(hi - max(vs)) <= 1e-9 * max(vs)
        allv = [v for vs in by_k.values() for v in vs]
        want = max(allv) / min(allv)
        assert abs(got["spread"] - want) <= 1e-9 * want


if __name__ == "__main__":
    _reference_counts(sys.argv[1])
