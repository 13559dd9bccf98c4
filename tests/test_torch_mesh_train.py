"""The port's LM training path on a four-rank mesh, against the JAX
package's on four forced host devices and against the port's own no-mesh
path, on the CPU.

The harness is ``tests/test_torch_mesh.py``'s: one module-scoped run in
which the test process draws numpy weights and batches, four spawned gloo
ranks run the port on ``make_host_mesh`` while this file, run as a script
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, runs the
reference on Auto meshes built with ``jax.sharding.Mesh``.  The
reference's ``jax.jit`` is built inside ``sharding_rules``: one traced
outside and called inside reuses the no-mesh trace.  Float32 throughout.

* (1, 4), 'seq': one ``make_train_step`` of 2 microbatches (the port with
  remat "dots", the reference without) from the reference's initial state
  carried by ``train_state_from_jax(..., mesh=)``, for reduced Qwen3-4B,
  DeepSeek-V2 (capacity factor 1.25: both drop the same pairs), RecurrentGemma-2B,
  xLSTM-350M and Whisper-small; S = 1024 where causal global attention
  runs (``parity_seq``).  Loss and grad norm within rel 1e-5, every
  parameter and moment leaf within rel 1e-5 of its max.
* (2, 2), both attention modes: loss and gradients of ``loss_fn`` on the
  mesh against the port's no-mesh path (MoE models at capacity factor 100,
  ``aux_weight=0``: the mesh's auxiliary loss is the mean of each shard's,
  the reference's definition).  Loss within rel 1e-5, every gradient leaf
  within rel 1e-4 of its max; a gradient twice or half as large fails that
  bound.  One train step at (2, 2) with masked labels against the no-mesh
  step, and the eval step.
* The reference's data-axis fault in training: its (2, 2) DeepSeek-V2 loss
  at capacity factor 100 is off its no-mesh loss by more than 100 times
  the tolerance; the port's is within it.
* Remat "dots" and remat off give the same loss and gradients on the mesh.
* int8 moments on shards: a last axis whose shard boundaries split a
  128-wide block, and one of 100 (one block) split over four ranks: each
  shard's ``q`` and ``s`` equal ``quantize_i8`` of the full tensor bit for
  bit, and three int8 AdamW steps, two rows at a time, equal the no-mesh
  steps bit for bit.
* ``train_state_from_jax(..., mesh=)`` places int8 moments as
  ``init_opt_state`` does on the mesh model.
* A state saved on (2, 2) restores leaf for leaf onto (1, 4) and onto no
  mesh.
* ``train_loop(mesh=)``: resumed equals uninterrupted bit for bit, and its
  losses are within rel 1e-5 of ``train_loop()`` without a mesh.
* DP-SGD on a mesh raises ``NotImplementedError``.
"""
import dataclasses
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_mesh import _draw, _rel, flatten, unflatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5           # loss, grad norm, a train step's leaves
REL_GRAD = 1e-4      # each gradient leaf, of its max
NO_DROPS = 100.0     # a capacity factor at which nothing drops
# eps = 1e-3: Adam's first update lr * g / (|g| + eps) moves a parameter by
# up to lr / eps times its gradient's rounding.  The mLSTM's float32
# gradients differ from the reference's by about 4e-6 of their max on the
# CPU, with or without a mesh; at eps = 1e-4 (tests/test_torch_train.py)
# that puts xLSTM's b_if 3.0e-5 (no mesh) and 6.0e-5 (on (1, 4)) of its max
# off after one step; at 1e-3, 4.2e-6 without a mesh.
OPT = dict(lr=1e-3, warmup_steps=2, eps=1e-3)
REF_ARCHS = ("qwen3-4b", "deepseek-v2-236b", "recurrentgemma-2b",
             "xlstm-350m", "whisper-small")
# name -> (arch, attention mode); all at (2, 2) against the no-mesh path
OWN = {f"own22-{a}-seq": (a, "seq") for a in REF_ARCHS}
OWN.update({f"own22-{a}-heads": (a, "heads")
            for a in ("qwen3-4b", "whisper-small", "kimi-k2-1t-a32b")})
B_OWN, S_OWN = 4, 16
FAULT = "fault22"    # the reference's DeepSeek-V2 at (2, 2), no drops
FAULT_PORT = "own22-deepseek-v2-236b-seq"   # the port's, on the same weights
INT8_SHAPES = {"split": (6, 640), "one_block": (5, 100)}
LOOP = dict(steps=4, batch_size=8, seq_len=16, microbatches=2, ckpt_every=2)


def config(shapes, arch, cf=None):
    """The reduced config of ``arch`` (``shapes`` from either package), at
    capacity factor ``cf`` when given."""
    cfg = shapes.reduced_config(arch)
    if cf is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def parity_seq(cfg) -> int:
    """1024 (the reference's kv_block) where causal global attention runs."""
    return 1024 if set(cfg.block_kinds()) & {"attn", "mla"} else 64


def make_batch(cfg, B, S, seed):
    """Tokens (or frames), labels with masked positions, numpy."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "embed_stub":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, 0] = -1
    labels[B - 1, 3:7] = -1          # the microbatches' masks differ
    batch["labels"] = labels
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _load(path):
    with np.load(path) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# The port's side: four gloo ranks
# ---------------------------------------------------------------------------

def _full(x):
    """A DTensor gathered (a collective), as numpy; a plain tensor as it is."""
    from repro_torch.models.sharding import is_dtensor
    if is_dtensor(x):
        x = x.full_tensor()
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flat_state(state):
    from repro_torch.models.layers import tree_paths
    return {k: _full(v) for k, v in tree_paths(
        {"params": state["params"], "m": state["opt"]["m"],
         "v": state["opt"]["v"]}).items()}


def _loss_and_grads(model, batch, remat=False, aux_weight=0.0):
    """(loss, {path: full gradient}) of ``model.loss_fn`` by backward()."""
    from repro_torch.models.layers import tree_paths
    from repro_torch.train.optimizer import placed_like
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    loss = model.loss_fn(batch, remat=remat, aux_weight=aux_weight)
    loss.backward()
    grads = {}
    for k, p in tree_paths(model.tree()).items():
        g = torch.zeros_like(p) if p.grad is None else placed_like(p.grad, p)
        grads[k] = _full(g)
    model.requires_grad_(False)
    return float(loss.detach()), grads


def _tensors(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _rank_main(rank, world, store_path, wdir, out):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import load_all, shapes
    from repro_torch.convert import lm_params_from_jax, train_state_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models.layers import tree_paths
    from repro_torch.models.sharding import place
    from repro_torch.train import (AdamWConfig, DPSGDConfig, apply_updates,
                                   init_opt_state, make_eval_step,
                                   make_train_step)
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train import optimizer
    from repro_torch.train.optimizer import quantize_i8, quantize_shard
    from repro_torch.train.train_step import init_train_state
    torch.set_num_threads(1)
    load_all()
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))

    def save(name, arrays):
        if rank == 0:
            np.savez(f"{out}/{name}.npz", **arrays)

    try:
        mesh14 = make_host_mesh("cpu", (1, 4))
        mesh22 = make_host_mesh("cpu", (2, 2))
        opt_cfg = AdamWConfig(**OPT)
        # (1, 4) against the reference: one train step
        for arch in REF_ARCHS:
            cfg = config(shapes, arch)
            w = unflatten(_load(f"{wdir}/ref-{arch}.npz"))
            zeros = {k: np.zeros_like(v) for k, v in flatten(w).items()}
            conv = train_state_from_jax(cfg, {"params": w, "opt": {
                "m": unflatten(zeros), "v": unflatten(zeros),
                "count": np.zeros((), np.int32)}}, mesh=mesh14)
            model = Model.from_params(cfg, conv["params"], mesh=mesh14)
            state = init_train_state(model, opt_cfg)
            state["opt"] = dict(conv["opt"], count=torch.zeros((), dtype=torch.int32))
            step = make_train_step(model, opt_cfg, microbatches=2, remat=True)
            state, met = step(state, _load(f"{wdir}/batch-ref-{arch}.npz"))
            got = _flat_state(state)
            got["loss"], got["grad_norm"] = float(met["loss"]), float(met["grad_norm"])
            save(f"ref-{arch}", got)
        # (2, 2) against the port's no-mesh path: loss and gradients
        for name, (arch, mode) in OWN.items():
            cfg = config(shapes, arch, NO_DROPS)
            params = lm_params_from_jax(cfg, unflatten(_load(f"{wdir}/{name}.npz")),
                                        mesh=mesh22)
            model = Model.from_params(cfg, params, mesh=mesh22)
            batch = _tensors(_load(f"{wdir}/batch-{name}.npz"))
            L.set_attn_sharding(mode)
            try:
                loss, grads = _loss_and_grads(model, batch)
                got = {f"grad/{k}": v for k, v in grads.items()}
                got["loss"] = loss
                if name == FAULT_PORT:
                    rl, rg = _loss_and_grads(model, batch, remat=True)
                    got["remat_equal"] = rl == loss and all(
                        np.array_equal(rg[k], grads[k]) for k in grads)
            finally:
                L.set_attn_sharding("seq")
            save(name, got)
        # (2, 2): a train step, the eval step, a sharded save restored onto
        # (1, 4) and onto no mesh
        cfg = config(shapes, "qwen3-4b")
        params = lm_params_from_jax(cfg, unflatten(_load(f"{wdir}/step22.npz")),
                                    mesh=mesh22)
        model = Model.from_params(cfg, params, mesh=mesh22)
        batch = _load(f"{wdir}/batch-own.npz")
        state = init_train_state(model, opt_cfg)
        ev = float(make_eval_step(model)(state["params"], batch))
        state, met = make_train_step(model, opt_cfg, microbatches=2,
                                     remat=False)(state, batch)
        got = _flat_state(state)
        got.update(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                   eval=ev)
        mgr = CheckpointManager(f"{out}/ckpt22")
        mgr.save(1, state)
        other = Model.init(cfg, torch.Generator().manual_seed(5), mesh=mesh14)
        back, manifest = mgr.restore(init_train_state(other, opt_cfg))
        placed = all(p.device_mesh is mesh14 for p in other.parameters())
        restored = _flat_state(back)
        got["restored14_equal"] = placed and manifest["step"] == 1 and all(
            np.array_equal(restored[k], got[k]) for k in restored)
        if rank == 0:
            plain = Model.init(cfg, torch.Generator().manual_seed(5), device="cpu")
            back, _ = mgr.restore(init_train_state(plain, opt_cfg))
            restored = _flat_state(back)
            got["restored_plain_equal"] = all(
                np.array_equal(restored[k], got[k]) for k in restored)
        save("step22", got)
        # int8 moments on shards
        rng = np.random.default_rng(7)
        got = {}
        for label, shape in INT8_SHAPES.items():
            full = torch.tensor(rng.standard_normal(shape).astype(np.float32))
            fq, fs = quantize_i8(full)
            for mname, mesh, pl in (
                    ("14", mesh14, [Replicate(), Shard(1)]),
                    ("22", mesh22, [Shard(0), Shard(1)])):
                p = place(full, mesh, pl)
                q, s = quantize_shard(p.to_local(), p)
                qd, sd = place(fq, mesh, pl), place(fs, mesh, [pl[0], Replicate()])
                got[f"{label}/{mname}"] = bool(
                    torch.equal(q, qd.to_local()) and torch.equal(s, sd.to_local()))
            # three int8 steps on (2, 2), two rows of a leaf at a time,
            # against three steps without a mesh, whole leaves, bit for bit
            icfg = AdamWConfig(int8_states=True, grad_clip=1e9, **OPT)
            pl = [Shard(0), Shard(1)]
            grads = [torch.tensor(rng.standard_normal(shape).astype(np.float32))
                     for _ in range(3)]
            plain, sharded = {"w": full.clone()}, {"w": place(full, mesh22, pl)}
            ps, ss = init_opt_state(plain, icfg), init_opt_state(sharded, icfg)
            for g in grads:
                plain, ps, _ = apply_updates(plain, {"w": g}, ps, icfg)
            default, optimizer.CHUNK = optimizer.CHUNK, 2 * shape[-1]
            try:
                for g in grads:
                    sharded, ss, _ = apply_updates(
                        sharded, {"w": place(g, mesh22, pl)}, ss, icfg)
            finally:
                optimizer.CHUNK = default
            pairs = [(sharded["w"], plain["w"])] + [
                (ss[m]["w"][k], ps[m]["w"][k]) for m in ("m", "v")
                for k in ("q", "s")]
            got[f"{label}/steps"] = all(np.array_equal(_full(a), b.numpy())
                                        for a, b in pairs)
        # a JAX state with int8 moments placed by train_state_from_jax: the
        # values of the no-mesh conversion, the placements of init_opt_state
        cfg = config(shapes, "qwen3-4b")
        w = _load(f"{wdir}/step22.npz")
        mom = unflatten({k: {"q": rng.integers(-127, 128, v.shape).astype(np.int8),
                             "s": rng.random(v.shape[:-1] + (
                                 v.shape[-1] // 128 if v.shape[-1] % 128 == 0
                                 else 1,)).astype(np.float32)}
                         for k, v in w.items()})
        jstate = {"params": unflatten(w), "opt": {"m": mom, "v": mom,
                                                  "count": np.zeros((), np.int32)}}
        placed = train_state_from_jax(cfg, jstate, mesh=mesh22)
        want = tree_paths(train_state_from_jax(cfg, jstate)["opt"])
        model = Model.from_params(cfg, placed["params"], mesh=mesh22)
        zeros = tree_paths(init_opt_state(model.tree(),
                                          AdamWConfig(int8_states=True)))
        got["from_jax"] = all(
            np.array_equal(_full(x), want[k])
            and tuple(x.placements) == tuple(zeros[k].placements)
            for k, x in tree_paths(placed["opt"]).items() if k != "count")
        save("int8", got)
        # train_loop on (2, 2): uninterrupted, and resumed half way
        cfg = config(shapes, "qwen3-4b")
        _, full_run = train_loop(cfg, ckpt_dir=f"{out}/loop_a", resume=False,
                                 dp=None, mesh=mesh22, **LOOP)
        first = dict(LOOP, steps=LOOP["steps"] // 2)
        _, head = train_loop(cfg, ckpt_dir=f"{out}/loop_b", resume=False,
                             dp=None, mesh=mesh22, **first)
        _, tail = train_loop(cfg, ckpt_dir=f"{out}/loop_b", resume=True,
                             dp=None, mesh=mesh22, **LOOP)
        raised = []
        for call in (lambda: train_loop(cfg, ckpt_dir=f"{out}/loop_dp",
                                        resume=False, dp=DPSGDConfig(),
                                        mesh=mesh22, **LOOP),
                     lambda: make_train_step(model, opt_cfg, dp=DPSGDConfig())):
            try:
                call()
                raised.append(False)
            except NotImplementedError:
                raised.append(True)
        save("loop", {"full": np.array(full_run), "resumed": np.array(head + tail),
                      "dp_raises": np.array(raised)})
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's side: this file as a script on four forced host devices
# ---------------------------------------------------------------------------

def _reference_main(wdir, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import load_all, shapes
    from repro.models import Model
    from repro.models.sharding import sharding_rules
    from repro.train import optimizer as jopt
    from repro.train import train_step as jstep
    load_all()

    def mesh_of(shape):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))

    jcfg = jopt.AdamWConfig(**OPT)
    for arch in REF_ARCHS:
        cfg = config(shapes, arch)
        model = Model(cfg)
        params = jax.tree_util.tree_map(
            jnp.asarray, unflatten(_load(f"{wdir}/ref-{arch}.npz")))
        state = {"params": params, "opt": jopt.init_opt_state(params, jcfg),
                 "rng": jax.random.PRNGKey(0)}
        batch = {k: jnp.asarray(v)
                 for k, v in _load(f"{wdir}/batch-ref-{arch}.npz").items()}
        with sharding_rules(mesh_of((1, 4))):
            step = jax.jit(jstep.make_train_step(model, jcfg, microbatches=2,
                                                 remat=False))
            new, met = step(state, batch)
        got = {f"{k}": np.asarray(v) for k, v in flatten(
            {"params": new["params"], "m": new["opt"]["m"],
             "v": new["opt"]["v"]}).items()}
        got["loss"], got["grad_norm"] = float(met["loss"]), float(met["grad_norm"])
        np.savez(f"{out}/ref-{arch}.npz", **got)
    # the data-axis fault in training: DeepSeek-V2 at (2, 2), no drops
    cfg = config(shapes, "deepseek-v2-236b", NO_DROPS)
    model = Model(cfg)
    params = jax.tree_util.tree_map(
        jnp.asarray, unflatten(_load(f"{wdir}/{FAULT_PORT}.npz")))
    batch = {k: jnp.asarray(v)
             for k, v in _load(f"{wdir}/batch-{FAULT_PORT}.npz").items()}
    losses = {}
    for label, mesh in (("mesh", mesh_of((2, 2))), ("plain", None)):
        with sharding_rules(mesh):
            losses[label] = float(jax.jit(lambda p, b: model.loss_fn(
                p, b, remat=False, aux_weight=0.0))(params, batch))
    np.savez(f"{out}/{FAULT}.npz", **losses)


# ---------------------------------------------------------------------------
# The run and the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.configs import load_all, shapes
    from repro.models import Model as JaxModel
    load_all()
    base = tmp_path_factory.mktemp("mesh_train")
    wdir, port, ref = (base / "weights", base / "port", base / "ref")
    for d in (wdir, port, ref):
        d.mkdir()
    for i, arch in enumerate(REF_ARCHS):
        cfg = config(shapes, arch)
        params = _draw(JaxModel(cfg).param_defs(), np.random.default_rng(i))
        np.savez(wdir / f"ref-{arch}.npz", **flatten(params))
        np.savez(wdir / f"batch-ref-{arch}.npz",
                 **make_batch(cfg, 2, parity_seq(cfg), seed=i))
    for i, (name, (arch, _)) in enumerate(OWN.items()):
        cfg = config(shapes, arch, NO_DROPS)
        params = _draw(JaxModel(cfg).param_defs(), np.random.default_rng(20 + i))
        np.savez(wdir / f"{name}.npz", **flatten(params))
        np.savez(wdir / f"batch-{name}.npz",
                 **make_batch(cfg, B_OWN, S_OWN, seed=20 + i))
    cfg = config(shapes, "qwen3-4b")
    np.savez(wdir / "step22.npz", **flatten(
        _draw(JaxModel(cfg).param_defs(), np.random.default_rng(40))))
    np.savez(wdir / "batch-own.npz", **make_batch(cfg, B_OWN, S_OWN, seed=41))

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(wdir), str(ref)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ctx = mp.get_context("spawn")
    ranks = [ctx.Process(target=_rank_main,
                         args=(r, 4, str(base / "store"), str(wdir), str(port)))
             for r in range(4)]
    for p in ranks:
        p.start()
    for p in ranks:
        p.join(timeout=300)
    hung = [p for p in ranks if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(5)
    log, _ = proc.communicate(timeout=300)
    assert not hung, "a gloo rank did not finish within 300 s"
    assert all(p.exitcode == 0 for p in ranks), [p.exitcode for p in ranks]
    assert proc.returncode == 0, log.decode()[-3000:]
    return {"port": port, "ref": ref, "weights": wdir}


def _no_mesh(name, runs):
    """The port's no-mesh loss and gradients on an OWN case's weights."""
    from repro_torch.configs import load_all, shapes
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import Model
    load_all()
    arch, _ = OWN[name]
    cfg = config(shapes, arch, NO_DROPS)
    params = unflatten(_load(runs["weights"] / f"{name}.npz"))
    model = Model.from_params(cfg, lm_params_from_jax(cfg, params), device="cpu")
    batch = _tensors(_load(runs["weights"] / f"batch-{name}.npz"))
    return _loss_and_grads(model, batch)


def _port_layout(cfg, flat):
    """A reference state's flat arrays in the port's layout: {path: array}."""
    from repro_torch.convert import train_state_from_jax
    from repro_torch.models.layers import tree_paths
    tree = unflatten({k: v for k, v in flat.items()
                      if k.split("/")[0] in ("params", "m", "v")})
    conv = train_state_from_jax(cfg, {"params": tree["params"], "opt": {
        "m": tree["m"], "v": tree["v"], "count": np.zeros((), np.int32)}})
    return tree_paths({"params": conv["params"], "m": conv["opt"]["m"],
                       "v": conv["opt"]["v"]})


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_train_step_matches_reference_at_1x4(runs, arch):
    """One step of 2 microbatches on (1, 4) against the reference's on the
    same mesh: loss, grad norm, every parameter and moment leaf."""
    from repro_torch.configs import load_all, shapes
    load_all()
    got = _load(runs["port"] / f"ref-{arch}.npz")
    want = _load(runs["ref"] / f"ref-{arch}.npz")
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(want[k])) <= REL * abs(float(want[k])), k
    leaves = _port_layout(config(shapes, arch), want)
    assert set(leaves) == {k for k in got if k not in ("loss", "grad_norm")}
    for k, w in leaves.items():
        assert got[k].shape == w.shape, k
        assert _rel(got[k], w) < REL, k


@pytest.mark.parametrize("name", list(OWN))
def test_loss_and_grads_at_2x2_match_no_mesh(runs, name):
    """Loss and every gradient leaf on (2, 2) against the no-mesh path; a
    gradient twice or half as large as the mesh's fails the bound."""
    got = _load(runs["port"] / f"{name}.npz")
    want_l, want_g = _no_mesh(name, runs)
    assert abs(float(got["loss"]) - want_l) <= REL * abs(want_l)
    assert {k for k in got if k.startswith("grad/")} == \
        {f"grad/{k}" for k in want_g}
    for k, w in want_g.items():
        g = got[f"grad/{k}"]
        assert g.shape == w.shape, k
        assert _rel(g, w) < REL_GRAD, k
        if np.abs(w).max() > 0:
            assert _rel(2 * g, w) > REL_GRAD and _rel(g / 2, w) > REL_GRAD, k


def test_reference_data_axis_fault_shown_in_training(runs):
    """DeepSeek-V2 at (2, 2) and capacity factor 100: the reference's loss
    on the mesh is off its no-mesh loss by more than 100 times the
    tolerance (its expert-parallel MoE adds other rows' partial sums), the
    port's is within the tolerance of the port's no-mesh loss."""
    want = _load(runs["ref"] / f"{FAULT}.npz")
    assert abs(float(want["mesh"]) - float(want["plain"])) \
        > 100 * REL * abs(float(want["plain"]))
    got = _load(runs["port"] / f"{FAULT_PORT}.npz")
    plain, _ = _no_mesh(FAULT_PORT, runs)
    assert abs(float(got["loss"]) - plain) <= REL * abs(plain)


def test_remat_dots_equals_remat_off_on_the_mesh(runs):
    """DeepSeek-V2 (MLA, the expert-parallel all_to_alls) at (2, 2): the
    loss and every gradient with remat "dots" equal those without remat,
    bit for bit."""
    assert bool(_load(runs["port"] / f"{FAULT_PORT}.npz")["remat_equal"])


def test_train_step_at_2x2_matches_no_mesh(runs):
    """One step of 2 microbatches (each a global chunk of the batch, masked
    differently) on (2, 2) against the same step without a mesh: loss,
    grad norm, every parameter and moment leaf; and the eval step's loss on
    the initial parameters."""
    from repro_torch.configs import load_all, shapes
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_paths
    from repro_torch.train import AdamWConfig, make_eval_step, make_train_step
    from repro_torch.train.train_step import init_train_state
    load_all()
    cfg = config(shapes, "qwen3-4b")
    params = unflatten(_load(runs["weights"] / "step22.npz"))
    model = Model.from_params(cfg, lm_params_from_jax(cfg, params), device="cpu")
    opt_cfg = AdamWConfig(**OPT)
    batch = _load(runs["weights"] / "batch-own.npz")
    state = init_train_state(model, opt_cfg)
    ev = float(make_eval_step(model)(state["params"], batch))
    state, met = make_train_step(model, opt_cfg, microbatches=2,
                                 remat=False)(state, batch)
    got = _load(runs["port"] / "step22.npz")
    assert abs(float(got["eval"]) - ev) <= REL * abs(ev)
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(met[k])) <= REL * abs(float(met[k])), k
    want = tree_paths({"params": state["params"], "m": state["opt"]["m"],
                       "v": state["opt"]["v"]})
    for k, w in want.items():
        assert _rel(got[k], w.detach().numpy()) < REL, k


def test_sharded_checkpoint_restores_onto_other_meshes(runs):
    """A state saved on (2, 2) (gathered, written by rank 0) restores leaf
    for leaf, bit for bit, onto (1, 4) and onto no mesh."""
    got = _load(runs["port"] / "step22.npz")
    assert bool(got["restored14_equal"])
    assert bool(got["restored_plain_equal"])


@pytest.mark.parametrize("label", list(INT8_SHAPES))
def test_int8_moments_on_shards_bit_for_bit(runs, label):
    """(6, 640) split over four ranks puts 160 columns on each, so shard
    boundaries split 128-wide blocks; (5, 100) is one block across every
    shard.  On (1, 4) and on (2, 2) (rows split over ``data`` too) each
    shard's q and s equal the full tensor's ``quantize_i8`` bit for bit,
    and three int8 AdamW steps on (2, 2) equal the no-mesh steps bit for
    bit (clipping off: the global norm sums in another order)."""
    got = _load(runs["port"] / "int8.npz")
    for key in ("14", "22", "steps"):
        assert bool(got[f"{label}/{key}"]), key


def test_train_state_from_jax_places_int8_moments(runs):
    """``train_state_from_jax(..., mesh=)`` on (2, 2) with int8 moments:
    every q and s leaf holds the no-mesh conversion's values and is placed
    as ``init_opt_state`` places the moments of the mesh model (q like its
    parameter, s with the last axis whole)."""
    assert bool(_load(runs["port"] / "int8.npz")["from_jax"])


def test_train_loop_on_a_mesh_resumes_bit_for_bit(runs):
    """``train_loop(mesh=)`` on (2, 2): 4 steps in one run equal 2 steps
    then 2 resumed from the checkpoint, bit for bit, and come within rel
    1e-5 of ``train_loop()`` without a mesh."""
    from repro_torch.configs import load_all, shapes
    from repro_torch.launch.train import train_loop
    load_all()
    got = _load(runs["port"] / "loop.npz")
    assert np.array_equal(got["full"], got["resumed"])
    _, plain = train_loop(config(shapes, "qwen3-4b"),
                          ckpt_dir=str(runs["weights"] / "loop_plain"),
                          resume=False, dp=None, device="cpu", **LOOP)
    assert len(plain) == LOOP["steps"]
    assert np.all(np.abs(got["full"] - plain) <= REL * np.abs(plain))


def test_dp_sgd_on_a_mesh_raises(runs):
    """``train_loop(dp=..., mesh=...)`` and ``make_train_step(mesh model,
    dp=...)`` raise NotImplementedError."""
    assert np.all(_load(runs["port"] / "loop.npz")["dp_raises"])


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
