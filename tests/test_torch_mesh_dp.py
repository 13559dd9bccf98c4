"""DP-SGD on a four-rank mesh in the port, against the port's no-mesh
DP-SGD and against the JAX package's on four forced host devices, on the
CPU.

The harness is ``tests/test_torch_mesh.py``'s: the test process draws
numpy weights and batches, four spawned gloo ranks run the port on
``make_host_mesh`` while this file, run as a script with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, runs the reference
on Auto meshes.  Float32 throughout; every leaf within rel 1e-5 of its
max.  The MoE's auxiliary loss is off where gradients are compared (the
mesh's is the mean of each shard's Switch loss, the reference's definition,
a different statistic from the no-mesh one).

* Clipping against no mesh: ``per_example_clipped_grad`` at (1, 4) and
  (2, 2) equals the no-mesh result for reduced Qwen3-4B, xLSTM-350M and
  DeepSeek-V2 (capacity factor 100, nothing drops).  The clip is small
  enough that every example is clipped, so each example's norm must be
  its whole gradient's.
* Capacity drops: DeepSeek-V2 at capacity factor 1.0, where the mesh
  drops pairs (the no-mesh MoE computes every expert, so it has no
  drops to compare): at (1, 4) against the reference at (1, 4), and at
  (2, 2), whose examples run on two ``model`` ranks each, against the
  reference at (1, 2).  Each example is routed alone with its own
  capacity, in both packages.  The reference's MoE is compared at
  ``data`` = 1 only: at ``data`` > 1 it is wrong (ROADMAP queue 3).
* Against the reference at (1, 4): the clipped gradients of Qwen3-4B and
  xLSTM-350M, and one DP train step of Qwen3-4B at a noise multiplier of
  1e-12, whose noise lies far below the tolerance (ROADMAP parity rule 1:
  the two packages' noise is never compared).
* A DP train step (2 microbatches, noise multiplier 1) at (1, 4) and
  (2, 2) equals the no-mesh DP step from the same generator state: the
  mesh draws each leaf's noise at its global shape.
* Noise: ``add_dp_noise`` on a (2, 2)-placed tree equals the no-mesh draw
  bit for bit, with mean 0 and std C·σ/B.
* ``train_loop(dp=, mesh=)`` at (2, 2): resumed equals uninterrupted bit
  for bit; an accountant whose budget funds 3 steps stops a 4-step run
  before its fourth step and counts 3.
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
from test_torch_mesh_train import OPT, _full, _load, make_batch, parity_seq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
CLIP = 1e-3          # below every example's gradient norm: all are clipped
B = 4
# name -> (arch, capacity factor)
CLIP_CASES = {"qwen3-4b": ("qwen3-4b", None), "xlstm-350m": ("xlstm-350m", None),
              "deepseek-v2-236b": ("deepseek-v2-236b", 100.0)}
DROPS = ("deepseek-drops", "deepseek-v2-236b", 1.0)
REF_CLIP = ("qwen3-4b", "xlstm-350m")
STEP_ARCHS = ("qwen3-4b", "xlstm-350m")
SHAPES = {"14": (1, 4), "22": (2, 2)}
TINY_NOISE = 1e-12
NOISE_SHAPE = (64, 2048)
LOOP = dict(steps=4, batch_size=4, seq_len=16, microbatches=2, ckpt_every=2)


def config(shapes, arch, cf=None):
    cfg = shapes.reduced_config(arch)
    if cf is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def _cases():
    """name -> (arch, capacity factor, S) of every clipped-gradient case."""
    out = {n: (a, cf, 64) for n, (a, cf) in CLIP_CASES.items()}
    for a in REF_CLIP:
        out[f"ref-{a}"] = (a, None, None)          # S from parity_seq
    out[DROPS[0]] = (DROPS[1], DROPS[2], None)
    return out


def _seq(cfg, S):
    return parity_seq(cfg) if S is None else S


# ---------------------------------------------------------------------------
# The port's side: four gloo ranks
# ---------------------------------------------------------------------------

def aux_free_loss(model):
    """``loss(params, batch)`` of ``model`` without the MoE auxiliary term."""
    from repro_torch.models.layers import tree_paths
    return lambda p, b: torch.func.functional_call(
        model, tree_paths(p, "."), (b,), {"aux_weight": 0.0})


def _tensors(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _flat_state(state):
    from repro_torch.models.layers import tree_paths
    return {k: _full(v) for k, v in tree_paths(
        {"params": state["params"], "m": state["opt"]["m"],
         "v": state["opt"]["v"]}).items()}


def _rank_main(rank, world, store_path, wdir, out):
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from repro_torch.configs import load_all, shapes
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.core.accountant import BudgetExhausted, PrivacyBudget
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_paths
    from repro_torch.models.moe import moe_stats, reset_moe_stats
    from repro_torch.models.sharding import place
    from repro_torch.train import AdamWConfig, DPSGDConfig, make_train_step
    from repro_torch.train.dp import (DPSGDAccountant, add_dp_noise,
                                      per_example_clipped_grad)
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
        meshes = {k: make_host_mesh("cpu", v) for k, v in SHAPES.items()}
        for name, (arch, cf, _) in _cases().items():
            cfg = config(shapes, arch, cf)
            w = unflatten(_load(f"{wdir}/{name}.npz"))
            batch = _tensors(_load(f"{wdir}/batch-{name}.npz"))
            for mk, mesh in meshes.items():
                if name.startswith("ref-") and mk != "14":
                    continue
                model = Model.from_params(cfg, lm_params_from_jax(
                    cfg, w, mesh=mesh), mesh=mesh)
                reset_moe_stats()
                g = per_example_clipped_grad(aux_free_loss(model),
                                             model.tree(), batch, CLIP)
                got = {k: _full(v) for k, v in tree_paths(g).items()}
                dropped = torch.tensor([moe_stats()["dropped"]])
                dist.all_reduce(dropped)
                got["dropped"] = int(dropped)
                save(f"clip-{name}-{mk}", got)
        opt_cfg = AdamWConfig(**OPT)
        for arch in STEP_ARCHS:
            cfg = config(shapes, arch)
            w = unflatten(_load(f"{wdir}/step-{arch}.npz"))
            for mk, mesh in meshes.items():
                model = Model.from_params(cfg, lm_params_from_jax(
                    cfg, w, mesh=mesh), mesh=mesh)
                step = make_train_step(model, opt_cfg, microbatches=2,
                                       dp=DPSGDConfig(clip_norm=CLIP))
                state, met = step(init_train_state(model, opt_cfg, seed=3),
                                  _load(f"{wdir}/batch-step-{arch}.npz"))
                got = _flat_state(state)
                got.update(loss=float(met["loss"]),
                           grad_norm=float(met["grad_norm"]))
                save(f"step-{arch}-{mk}", got)
        # against the reference: a step whose noise is far below the tolerance
        cfg = config(shapes, "qwen3-4b")
        model = Model.from_params(cfg, lm_params_from_jax(
            cfg, unflatten(_load(f"{wdir}/ref-qwen3-4b.npz")),
            mesh=meshes["14"]), mesh=meshes["14"])
        step = make_train_step(model, opt_cfg, microbatches=2, dp=DPSGDConfig(
            clip_norm=CLIP, noise_multiplier=TINY_NOISE))
        state, met = step(init_train_state(model, opt_cfg),
                          _load(f"{wdir}/batch-ref-qwen3-4b.npz"))
        got = _flat_state(state)
        got["loss"] = float(met["loss"])
        save("refstep", got)
        # the noise of a (2, 2)-placed tree
        zeros = {"a": place(torch.zeros(NOISE_SHAPE), meshes["22"],
                            [Shard(0), Shard(1)]),
                 "b": place(torch.zeros(NOISE_SHAPE[::-1]), meshes["22"],
                            [Shard(1), Shard(0)])}
        noisy = add_dp_noise(zeros, torch.Generator().manual_seed(9), 1.5,
                             2.0, 8)
        save("noise", {k: _full(v) for k, v in noisy.items()})
        # train_loop on (2, 2): uninterrupted, resumed, and out of budget
        cfg = config(shapes, "qwen3-4b")
        dp = DPSGDConfig(clip_norm=CLIP)
        _, whole = train_loop(cfg, ckpt_dir=f"{out}/loop_a", resume=False,
                              dp=dp, mesh=meshes["22"], **LOOP)
        _, head = train_loop(cfg, ckpt_dir=f"{out}/loop_b", resume=False,
                             dp=dp, mesh=meshes["22"],
                             **dict(LOOP, steps=LOOP["steps"] // 2))
        _, tail = train_loop(cfg, ckpt_dir=f"{out}/loop_b", resume=True,
                             dp=dp, mesh=meshes["22"], **LOOP)
        acct = DPSGDAccountant(dp, PrivacyBudget(3 * dp.pcost_per_step))
        refused = False
        try:
            train_loop(cfg, ckpt_dir=None, resume=False, dp=dp,
                       mesh=meshes["22"], accountant=acct, **LOOP)
        except BudgetExhausted:
            refused = True
        save("loop", {"whole": np.array(whole), "resumed": np.array(head + tail),
                      "refused": refused, "acct_steps": acct.steps,
                      "spent": acct.budget.spent})
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
    from repro.train import dp as jdp
    from repro.train import optimizer as jopt
    from repro.train import train_step as jstep
    load_all()

    def mesh_of(shape):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))

    def clipped(name, arch, cf, shape):
        model = Model(config(shapes, arch, cf))
        params = jax.tree_util.tree_map(
            jnp.asarray, unflatten(_load(f"{wdir}/{name}.npz")))
        batch = {k: jnp.asarray(v)
                 for k, v in _load(f"{wdir}/batch-{name}.npz").items()}
        with sharding_rules(mesh_of(shape)):
            g = jax.jit(lambda p, b: jdp.per_example_clipped_grad(
                lambda q, e: model.loss_fn(q, e, remat=False, aux_weight=0.0),
                p, b, CLIP))(params, batch)
        return {k: np.asarray(v) for k, v in flatten(g).items()}

    for arch in REF_CLIP:
        np.savez(f"{out}/clip-ref-{arch}.npz",
                 **clipped(f"ref-{arch}", arch, None, (1, 4)))
    name, arch, cf = DROPS
    for label, shape in (("14", (1, 4)), ("12", (1, 2))):
        np.savez(f"{out}/clip-{name}-{label}.npz",
                 **clipped(name, arch, cf, shape))
    cfg = config(shapes, "qwen3-4b")
    model = Model(cfg)
    jcfg = jopt.AdamWConfig(**OPT)
    params = jax.tree_util.tree_map(
        jnp.asarray, unflatten(_load(f"{wdir}/ref-qwen3-4b.npz")))
    state = {"params": params, "opt": jopt.init_opt_state(params, jcfg),
             "rng": jax.random.PRNGKey(0)}
    batch = {k: jnp.asarray(v)
             for k, v in _load(f"{wdir}/batch-ref-qwen3-4b.npz").items()}
    with sharding_rules(mesh_of((1, 4))):
        step = jax.jit(jstep.make_train_step(
            model, jcfg, microbatches=2, remat=False, dp=jdp.DPSGDConfig(
                clip_norm=CLIP, noise_multiplier=TINY_NOISE)))
        new, met = step(state, batch)
    got = {k: np.asarray(v) for k, v in flatten(
        {"params": new["params"], "m": new["opt"]["m"],
         "v": new["opt"]["v"]}).items()}
    got["loss"] = float(met["loss"])
    np.savez(f"{out}/refstep.npz", **got)


# ---------------------------------------------------------------------------
# The run and the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.configs import load_all, shapes
    from repro.models import Model as JaxModel
    load_all()
    base = tmp_path_factory.mktemp("mesh_dp")
    wdir, port, ref = (base / "weights", base / "port", base / "ref")
    for d in (wdir, port, ref):
        d.mkdir()
    for i, (name, (arch, cf, S)) in enumerate(_cases().items()):
        cfg = config(shapes, arch, cf)
        params = _draw(JaxModel(cfg).param_defs(), np.random.default_rng(50 + i))
        np.savez(wdir / f"{name}.npz", **flatten(params))
        np.savez(wdir / f"batch-{name}.npz",
                 **make_batch(cfg, B, _seq(cfg, S), seed=50 + i))
    for i, arch in enumerate(STEP_ARCHS):
        cfg = config(shapes, arch)
        np.savez(wdir / f"step-{arch}.npz", **flatten(
            _draw(JaxModel(cfg).param_defs(), np.random.default_rng(70 + i))))
        np.savez(wdir / f"batch-step-{arch}.npz",
                 **make_batch(cfg, B, 16, seed=70 + i))

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


def _plain_model(runs, shapes, name, arch, cf):
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import Model
    cfg = config(shapes, arch, cf)
    w = unflatten(_load(runs["weights"] / f"{name}.npz"))
    return Model.from_params(cfg, lm_params_from_jax(cfg, w), device="cpu")


def _port_grads(flat_ref, cfg):
    """The reference's flat gradient tree in the port's layout."""
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models.layers import tree_paths
    return {k: np.asarray(v) for k, v in tree_paths(
        lm_params_from_jax(cfg, unflatten(flat_ref))).items()}


def _assert_leaves(got, want, rel=REL):
    assert set(want) <= set(got), sorted(set(want) - set(got))[:3]
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert _rel(got[k], w) < rel, (k, _rel(got[k], w))


@pytest.mark.parametrize("mesh", list(SHAPES))
@pytest.mark.parametrize("name", list(CLIP_CASES))
def test_clipped_grad_on_a_mesh_matches_no_mesh(runs, name, mesh):
    """Every leaf of the mesh's clipped mean within rel 1e-5 of the no-mesh
    one (every example clipped, so each norm must be the whole
    gradient's); a gradient twice as large fails."""
    from repro_torch.configs import load_all, shapes
    from repro_torch.models.layers import tree_paths
    from repro_torch.train.dp import per_example_clipped_grad
    load_all()
    arch, cf = CLIP_CASES[name]
    model = _plain_model(runs, shapes, name, arch, cf)
    batch = _tensors(_load(runs["weights"] / f"batch-{name}.npz"))
    want = {k: v.detach().numpy() for k, v in tree_paths(
        per_example_clipped_grad(aux_free_loss(model), model.tree(), batch,
                                 CLIP)).items()}
    got = _load(runs["port"] / f"clip-{name}-{mesh}.npz")
    _assert_leaves(got, want)
    norm = np.sqrt(sum(np.sum(w.astype(np.float64) ** 2) for w in want.values()))
    assert norm <= CLIP * (1 + 1e-5)
    k = max(want, key=lambda k: np.abs(want[k]).max())
    assert _rel(2 * got[k], want[k]) > REL


@pytest.mark.parametrize("arch", REF_CLIP)
def test_clipped_grad_at_1x4_matches_reference(runs, arch):
    from repro_torch.configs import load_all, shapes
    load_all()
    want = _port_grads(_load(runs["ref"] / f"clip-ref-{arch}.npz"),
                       config(shapes, arch))
    _assert_leaves(_load(runs["port"] / f"clip-ref-{arch}-14.npz"), want)


@pytest.mark.parametrize("mesh,ref_mesh", [("14", "14"), ("22", "12")])
def test_moe_drops_route_each_example_alone(runs, mesh, ref_mesh):
    """DeepSeek-V2 at capacity factor 1.0: the mesh drops pairs, and the
    clipped gradient equals the reference's with each example routed alone
    on as many ``model`` ranks: (1, 4) against (1, 4); (2, 2), whose
    examples never meet the other data coordinate's, against (1, 2)."""
    from repro_torch.configs import load_all, shapes
    load_all()
    name, arch, cf = DROPS
    got = _load(runs["port"] / f"clip-{name}-{mesh}.npz")
    assert int(got["dropped"]) > 0
    want = _port_grads(_load(runs["ref"] / f"clip-{name}-{ref_mesh}.npz"),
                       config(shapes, arch, cf))
    _assert_leaves(got, want)


@pytest.mark.parametrize("mesh", list(SHAPES))
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_dp_step_on_a_mesh_matches_no_mesh(runs, arch, mesh):
    """One DP-SGD step (2 microbatches, noise multiplier 1) on the mesh
    against the no-mesh step from the same generator state: loss, grad
    norm, every parameter and moment leaf.  The noise (std C/B per entry)
    is larger than the clipped mean, so the leaves agree only if both draw
    the same noise."""
    from repro_torch.configs import load_all, shapes
    from repro_torch.models.layers import tree_paths
    from repro_torch.train import AdamWConfig, DPSGDConfig, make_train_step
    from repro_torch.train.train_step import init_train_state
    load_all()
    model = _plain_model(runs, shapes, f"step-{arch}", arch, None)
    opt_cfg = AdamWConfig(**OPT)
    step = make_train_step(model, opt_cfg, microbatches=2,
                           dp=DPSGDConfig(clip_norm=CLIP))
    state, met = step(init_train_state(model, opt_cfg, seed=3),
                      _load(runs["weights"] / f"batch-step-{arch}.npz"))
    got = _load(runs["port"] / f"step-{arch}-{mesh}.npz")
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) - float(met[k])) <= REL * abs(float(met[k])), k
    _assert_leaves(got, {k: v.detach().numpy() for k, v in tree_paths(
        {"params": state["params"], "m": state["opt"]["m"],
         "v": state["opt"]["v"]}).items()})


def test_dp_step_at_1x4_matches_reference(runs):
    """Qwen3-4B, one DP step at noise multiplier 1e-12 on (1, 4) in both
    packages: loss, every parameter and moment leaf."""
    from repro_torch.configs import load_all, shapes
    from repro_torch.convert import train_state_from_jax
    from repro_torch.models.layers import tree_paths
    load_all()
    want = _load(runs["ref"] / "refstep.npz")
    got = _load(runs["port"] / "refstep.npz")
    assert abs(float(got["loss"]) - float(want["loss"])) <= REL * abs(float(want["loss"]))
    tree = unflatten({k: v for k, v in want.items() if k != "loss"})
    conv = train_state_from_jax(config(shapes, "qwen3-4b"), {
        "params": tree["params"], "opt": {"m": tree["m"], "v": tree["v"],
                                          "count": np.zeros((), np.int32)}})
    _assert_leaves(got, {k: np.asarray(v) for k, v in tree_paths(
        {"params": conv["params"], "m": conv["opt"]["m"],
         "v": conv["opt"]["v"]}).items()})


def test_mesh_noise_is_the_global_draw(runs):
    """The (2, 2) noise equals the no-mesh draw from the same generator
    bit for bit, leaf by leaf in the tree's order; its moments are mean 0
    and std C·σ/B within 5 standard errors."""
    from repro_torch.train.dp import add_dp_noise
    got = _load(runs["port"] / "noise.npz")
    want = add_dp_noise({"a": torch.zeros(NOISE_SHAPE),
                         "b": torch.zeros(NOISE_SHAPE[::-1])},
                        torch.Generator().manual_seed(9), 1.5, 2.0, 8)
    std = 1.5 * 2.0 / 8
    for k in ("a", "b"):
        assert np.array_equal(got[k], want[k].numpy()), k
        x = got[k].astype(np.float64).ravel()
        se = std / np.sqrt(x.size)
        assert abs(x.mean()) < 5 * se
        assert abs(x.std() - std) < 5 * std / np.sqrt(2 * x.size)


def test_dp_train_loop_on_a_mesh(runs):
    """``train_loop(dp=, mesh=)`` at (2, 2): 4 steps equal 2 steps then 2
    resumed, bit for bit; a budget of 3 steps' pcost lets 3 steps run and
    refuses the fourth before it runs, and the accountant counts 3."""
    got = _load(runs["port"] / "loop.npz")
    assert len(got["whole"]) == LOOP["steps"]
    assert np.array_equal(got["whole"], got["resumed"])
    assert bool(got["refused"])
    assert int(got["acct_steps"]) == 3


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
