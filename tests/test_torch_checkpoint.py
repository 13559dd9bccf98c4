"""Checkpoints and the train loop of the PyTorch port (CPU).

* ``CheckpointManager``: roundtrip, ``keep``, asynchronous save, a stale
  ``.tmp`` never listed, a bf16 leaf restored in a fresh interpreter with
  no ``ml_dtypes`` loaded; the on-disk layout shared with the JAX package
  (a flat tree written by either package read by the other).
* ``train_loop``: a run resumed from its checkpoint gives the losses of an
  uninterrupted run bit for bit (plain and DP-SGD).  The reference's three
  faults are shown: ``--reduced`` cannot be switched off, a periodic
  checkpoint after step ``it`` is labelled ``it`` though it holds
  ``it + 1`` steps, and a resumed run restarts the token stream.
* The three training examples run once each at tiny sizes.
"""
import os
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
from repro.configs import shapes as jshapes
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
import repro_torch.launch.train as ttrain
from repro_torch.configs import load_all
from repro_torch.configs.shapes import reduced_config
from repro_torch.models import Model, get_config
from repro_torch.train import AdamWConfig, DPSGDConfig
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.models.layers import tree_leaves
from repro_torch.train.train_step import init_train_state

load_all()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
EXAMPLES = os.path.join(ROOT, "examples")


def _state():
    model = Model.init(reduced_config("qwen3-4b"), torch.Generator().manual_seed(0),
                       device="cpu")
    return init_train_state(model, AdamWConfig(int8_states=True))


def test_checkpoint_roundtrip_keep_and_async(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, state, {"arch": "x"})
    mgr.save(3, state, {"arch": "x"})
    mgr.save(7, state, {"arch": "x"}, blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [3, 7] and mgr.latest_step() == 7
    restored, manifest = mgr.restore(state)
    assert manifest["step"] == 7 and manifest["arch"] == "x"
    for a, b in zip(tree_leaves(state), tree_leaves(restored), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()
    old, _ = mgr.restore(state, step=3)
    assert torch.equal(old["params"]["lm_head"], state["params"]["lm_head"])


def test_async_save_holds_the_state_of_its_call(tmp_path):
    """The host copy is taken at save(): a later in-place update of the
    live tensors does not reach the checkpoint."""
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": w}, blocking=False)
    w.add_(100.0)
    mgr.wait()
    got, _ = mgr.restore({"w": w})
    assert torch.equal(got["w"], torch.arange(12, dtype=torch.float32).reshape(3, 4))


def test_save_copies_to_the_host_after_the_previous_save(tmp_path, monkeypatch):
    """A save takes its host copy only once the previous asynchronous save
    has finished, so at most one host copy of the state is held."""
    import repro_torch.train.checkpoint as ck
    mgr = CheckpointManager(str(tmp_path))
    write, host = mgr._write, ck._host
    busy = []

    def slow_write(*a):
        import time
        time.sleep(0.2)
        write(*a)

    def watched_host(x):
        busy.append(mgr._thread is not None and mgr._thread.is_alive())
        return host(x)

    monkeypatch.setattr(mgr, "_write", slow_write)
    monkeypatch.setattr(ck, "_host", watched_host)
    mgr.save(1, {"w": torch.ones(2)}, blocking=False)
    mgr.save(2, {"w": torch.zeros(2)}, blocking=False)
    mgr.save(3, {"w": torch.ones(2)})
    assert busy == [False, False, False]
    assert mgr.all_steps() == [1, 2, 3]


def test_failed_async_save_raises_on_wait(tmp_path):
    """A save whose thread fails (here: its directory became a file) raises
    at wait(), not never."""
    d = tmp_path / "ck"
    mgr = CheckpointManager(str(d))
    os.rmdir(d)
    d.write_text("not a directory")
    mgr.save(2, {"w": torch.ones(2)}, blocking=False)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                 # the error is raised once


def test_stale_tmp_never_listed(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4)})
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1


def test_bf16_restored_without_ml_dtypes(tmp_path):
    code = (
        "import sys, torch\n"
        "from repro_torch.train.checkpoint import CheckpointManager\n"
        f"m = CheckpointManager({str(tmp_path)!r})\n"
        "x = torch.randn(3, 130, generator=torch.Generator().manual_seed(0))"
        ".to(torch.bfloat16)\n"
        "m.save(1, {'w': x, 'c': torch.tensor(3, dtype=torch.int32)})\n"
        "st, man = m.restore({'w': torch.zeros(3, 130, dtype=torch.bfloat16),"
        " 'c': torch.zeros((), dtype=torch.int32)})\n"
        "assert man['dtypes'] == {'w': 'bfloat16', 'c': 'int32'}, man\n"
        "assert st['w'].dtype == torch.bfloat16 and torch.equal(st['w'], x)\n"
        "assert int(st['c']) == 3\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('ml_dtypes', 'jax', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _flat_tree(rng):
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(130).astype(np.float32),
            "q": rng.integers(-127, 128, (2, 128)).astype(np.int8),
            "count": np.asarray(5, np.int32),
            "nested": {"x": rng.standard_normal(6).astype(np.float32)}}


def test_jax_checkpoint_read_by_the_port(tmp_path):
    tree = _flat_tree(np.random.default_rng(0))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jtree["b"] = jtree["b"].astype(jnp.bfloat16)
    JaxCheckpointManager(str(tmp_path)).save(4, jtree, {"arch": "flat"})
    like = {"w": torch.zeros(4, 3), "b": torch.zeros(130, dtype=torch.bfloat16),
            "q": torch.zeros(2, 128, dtype=torch.int8),
            "count": torch.zeros((), dtype=torch.int32),
            "nested": {"x": torch.zeros(6)}}
    got, manifest = CheckpointManager(str(tmp_path)).restore(like)
    assert manifest["step"] == 4 and manifest["arch"] == "flat"
    assert manifest["dtypes"]["b"] == "bfloat16"
    for k in ("w", "q", "count"):
        assert np.array_equal(got[k].numpy(), tree[k]), k
    assert np.array_equal(got["nested"]["x"].numpy(), tree["nested"]["x"])
    assert got["b"].dtype == torch.bfloat16
    assert np.array_equal(got["b"].float().numpy(),
                          np.asarray(jtree["b"].astype(jnp.float32)))


def test_port_checkpoint_read_by_jax(tmp_path):
    tree = _flat_tree(np.random.default_rng(1))
    ttree = {k: torch.tensor(v) if not isinstance(v, dict)
             else {"x": torch.tensor(v["x"])} for k, v in tree.items()}
    ttree["b"] = ttree["b"].to(torch.bfloat16)
    CheckpointManager(str(tmp_path)).save(6, ttree, {"arch": "flat"})
    jlike = jax.tree_util.tree_map(jnp.asarray, tree)
    jlike["b"] = jlike["b"].astype(jnp.bfloat16)
    got, manifest = JaxCheckpointManager(str(tmp_path)).restore(jlike)
    assert manifest["step"] == 6
    for k in ("w", "q", "count"):
        assert np.array_equal(np.asarray(got[k]), tree[k]), k
    assert got["b"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(got["b"].astype(jnp.float32)),
                          ttree["b"].float().numpy())


RUN = dict(batch_size=2, seq_len=8, microbatches=2, device="cpu")


@pytest.mark.parametrize("dp", [None, DPSGDConfig(noise_multiplier=1.0)])
def test_resume_equals_uninterrupted_bit_for_bit(tmp_path, dp):
    cfg = reduced_config("qwen3-4b")
    _, whole = ttrain.train_loop(cfg, steps=9, ckpt_dir=str(tmp_path / "a"),
                                 resume=False, dp=dp, ckpt_every=3, **RUN)
    _, first = ttrain.train_loop(cfg, steps=6, ckpt_dir=str(tmp_path / "b"),
                                 resume=False, dp=dp, ckpt_every=3, **RUN)
    mgr = CheckpointManager(str(tmp_path / "b"))
    assert mgr.all_steps() == [3, 6]
    st, man = mgr.restore(init_train_state(Model.init(
        cfg, torch.Generator().manual_seed(0), device="cpu"), AdamWConfig()))
    assert int(st["opt"]["count"]) == man["step"] == 6
    _, rest = ttrain.train_loop(cfg, steps=9, ckpt_dir=str(tmp_path / "b"),
                                resume=True, dp=dp, ckpt_every=3, **RUN)
    assert first + rest == whole


def test_reference_resume_faults_shown(tmp_path):
    """The reference labels the checkpoint after step 2 as step 2 holding
    3 updates, and its resumed steps see other batches than an
    uninterrupted run's."""
    cfg = jshapes.reduced_config("qwen3-4b")
    run = dict(batch_size=2, seq_len=8, dp=None, microbatches=1)
    jtrain.train_loop(cfg, steps=3, ckpt_dir=str(tmp_path / "b"), resume=False,
                      ckpt_every=2, **run)
    mgr = JaxCheckpointManager(str(tmp_path / "b"))
    assert mgr.all_steps() == [2, 3]
    raw = np.load(os.path.join(str(tmp_path / "b"), "step_00000002", "arrays.npz"))
    assert int(raw["opt/count"]) == 3
    _, rest = jtrain.train_loop(cfg, steps=5, ckpt_dir=str(tmp_path / "b"),
                                resume=True, ckpt_every=0, **run)
    _, whole = jtrain.train_loop(cfg, steps=5, ckpt_dir=str(tmp_path / "a"),
                                 resume=False, ckpt_every=0, **run)
    assert len(rest) == 2 and rest != whole[3:]


def test_reduced_flag(monkeypatch):
    """The reference's --reduced is on under every argv (its full-config
    branch is dead); the port's --no-reduced takes the published config."""
    seen = []

    def fake_loop(cfg, **kw):
        seen.append(cfg)
        return None, [1.0, 0.5]

    monkeypatch.setattr(jtrain, "train_loop", fake_loop)
    for argv in ([], ["--reduced"], ["--arch", "xlstm-350m"]):
        monkeypatch.setattr(sys, "argv", ["train.py", *argv])
        jtrain.main()
    assert all(c.name.endswith("-smoke") for c in seen)
    monkeypatch.setattr(sys, "argv", ["train.py", "--no-reduced"])
    with pytest.raises(SystemExit):
        jtrain.main()
    seen.clear()
    monkeypatch.setattr(ttrain, "train_loop", fake_loop)
    ttrain.main(["--device", "cpu"])
    ttrain.main(["--device", "cpu", "--no-reduced", "--arch", "xlstm-350m"])
    assert seen[0] == reduced_config("qwen3-4b")
    assert seen[1] == get_config("xlstm-350m")


def test_train_example_runs(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "train_lm_torch.py", "--device", "cpu", "--steps", "3", "--batch", "2",
        "--seq", "8", "--dp-noise", "1.0", "--ckpt-dir", str(tmp_path)])
    runpy.run_path(os.path.join(EXAMPLES, "train_lm_torch.py"),
                   run_name="__main__")
    assert CheckpointManager(str(tmp_path)).all_steps() == [3]


def _example(name):
    return runpy.run_path(os.path.join(EXAMPLES, name))


def test_dp_corpus_stats_example_funds_three_steps():
    tables, steps, report = _example("dp_corpus_stats_torch.py")["main"](
        ["--device", "cpu"])
    assert steps == 3 and report["steps"] == 3 and report["pcost"] == 3.0
    assert tables[(0, 1)].shape == (64,)


def test_fault_tolerance_example_runs(tmp_path):
    first, second, restored, on_mesh = _example(
        "fault_tolerance_demo_torch.py")["main"](
        ["--device", "cpu", "--ckpt-dir", str(tmp_path), "--steps", "4",
         "--resume-to", "6", "--ckpt-every", "2", "--batch", "2", "--seq", "8"])
    assert len(first) == 4 and len(second) == 2
    assert int(restored["opt"]["count"]) == 6
    assert restored["params"]["lm_head"].device.type == "cpu"
    # phase 3's re-mesh: the same values, each a replicated DTensor
    from torch.distributed.tensor import DTensor, Replicate
    for a, b in zip(tree_leaves(on_mesh["params"]),
                    tree_leaves(restored["params"])):
        assert isinstance(a, DTensor)
        assert all(isinstance(pl, Replicate) for pl in a.placements)
        assert torch.equal(a.to_local(), b)


def _remesh_rank(rank, store_path, ckpt_dir, out_path):
    """One rank of the two-rank re-mesh: the checkpoint restored straight
    onto a (1, 2) mesh, each parameter placed by its PDef axes."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import tree_map
    from repro_torch.models.sharding import param_spec
    from repro_torch.models.transformer import model_defs
    load_all()
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cfg = reduced_config("qwen3-4b")
        mesh = make_host_mesh("cpu")
        like = Model.init(cfg, torch.Generator().manual_seed(1),
                          device="cpu").tree()
        shardings = tree_map(lambda pd: param_spec(mesh, pd.axes),
                             model_defs(cfg))
        state, manifest = CheckpointManager(ckpt_dir).restore(
            {"params": like}, shardings={"params": shardings})
        leaves = tree_leaves(state["params"])
        local = [t.to_local().clone() for t in leaves]
        sharded = sum(any(not pl.is_replicate() for pl in t.placements)
                      for t in leaves)
        full = [t.full_tensor() for t in leaves]
        torch.save({"full": full, "local": local, "sharded": sharded,
                    "step": manifest["step"]}, f"{out_path}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_restore_onto_a_two_rank_mesh_leaf_for_leaf(tmp_path):
    """A checkpoint written without a mesh lands on a two-rank gloo mesh
    through ``restore(..., shardings=)``: each rank holds its shard of every
    leaf (some split over ``model``), and gathered they equal the saved
    leaves bit for bit."""
    import torch.multiprocessing as mp
    load_all()
    cfg = reduced_config("qwen3-4b")
    params = Model.init(cfg, torch.Generator().manual_seed(0),
                        device="cpu").tree()
    CheckpointManager(str(tmp_path / "ckpt")).save(7, {"params": params})
    ctx = mp.get_context("spawn")
    out = str(tmp_path / "remesh")
    procs = [ctx.Process(target=_remesh_rank,
                         args=(r, str(tmp_path / "store"),
                               str(tmp_path / "ckpt"), out)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(5)
    assert not hung, "a gloo rank did not finish within 120 s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    want = tree_leaves(params)
    got = [torch.load(f"{out}.{r}.pt") for r in range(2)]
    for g in got:
        assert g["step"] == 7 and g["sharded"] > 0
        assert len(g["full"]) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(g["full"], want))
    assert any(a.shape != b.shape for a, b in zip(got[0]["local"], want))


def test_training_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = reduced_config("qwen3-4b")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train_loop(cfg, steps=1, ckpt_dir=str(tmp_path), resume=False,
                          dp=None, ckpt_every=0, batch_size=2, seq_len=8,
                          microbatches=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        _example("dp_corpus_stats_torch.py")["main"]([])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore({"w": torch.ones(2)}, device="cuda")
