"""The port's LM serving path on a four-rank mesh against the JAX package's
on four forced host devices, on the CPU.

One module-scoped run does the work: the test process draws numpy weights
for every case (from the reference's parameter defs) and writes them to
``tmp_path``; then, at the same time, four spawned gloo ranks (a
``FileStore`` under ``tmp_path``) run the port on ``make_host_mesh`` and
this file, run as a script in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu``, runs the reference on Auto meshes (``jax.make_mesh``
builds Explicit axes on jax 0.9, under which the reference's model raises
at ``jnp.take``).  Both sides load the weights through
``convert.lm_params_from_jax`` (the port with ``mesh=``).  Float32
throughout; tolerance rel 1e-5 of max |reference|.

* (1, 4), attention sharding 'seq', the ten reduced architectures at
  S = 1024 (the reference's ``kv_block``, where its attention pads
  nothing), the configs' capacity factor 1.25: prefill logits and caches,
  and one decode step fed the reference's prefill caches padded by key
  (its own prefill never pads them), against the reference on the same
  mesh.  At 1.25 the MoE drops pairs; the logits agree only if both drop
  the same ones.
* (2, 2), both attention modes, DeepSeek-V2, Kimi-K2 and Qwen3-4B at
  capacity factor 100 (no drops): the port on the mesh equals the port
  without one.  The reference's expert-parallel MoE on the same mesh is off
  its no-mesh output by more than 0.1 (its data-axis fault).
* Uneven shards (S = 10, 14 cache slots at model = 4): the port equals its
  no-mesh path.
* Padded heads (H = 10, Hkv = 2 at model = 4, G' = 6): the port equals its
  no-mesh path; the reference's padded-head path pads ``wo`` at the end,
  not group by group, and is shown off (by more than 100 times the
  tolerance).
* Straddled heads (xLSTM with 2 and 3 heads of 16 at model = 4, whose
  ``qkv`` columns split inside heads and across head boundaries): the port
  on (1, 4) equals the reference on the same mesh (logits and caches) and
  its own no-mesh path.
* The MoE alone at (1, 4) and capacity 1.25: the port's output equals the
  reference's and its dropped pairs equal the count the reference's drop
  rule gives on the reference's own routing.  At (2, 2) and 1.0 the same against
  the reference at (1, 2), the dispatch the port runs after gathering the
  batch over ``data``: the drops count once, not once per data rank.
"""
import dataclasses
import datetime
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("xlstm-350m", "recurrentgemma-2b", "qwen2.5-14b", "qwen1.5-32b",
         "yi-34b", "qwen3-4b", "kimi-k2-1t-a32b", "deepseek-v2-236b",
         "chameleon-34b", "whisper-small")
MOE_ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b")
REL = 1e-5
B = 2
EXTRA = 4                    # cache slots past the prompt
S_REF = 1024                 # the reference's kv_block
S_OWN = 16
NO_DROPS = 100.0             # a capacity factor at which nothing drops

# name -> (arch, mesh shape, attention mode, S, capacity factor, (H, Hkv))
CASES = {f"ref14-{a}": (a, (1, 4), "seq", S_REF, None, None) for a in ARCHS}
CASES.update({f"own22-{a}-{m}": (a, (2, 2), m, S_OWN, NO_DROPS, None)
              for a in ("deepseek-v2-236b", "kimi-k2-1t-a32b", "qwen3-4b")
              for m in ("seq", "heads")})
CASES["padded"] = ("qwen3-4b", (1, 4), "heads", S_OWN, None, (10, 2))
# S = 10 and 14 cache slots split unevenly over 4 ranks (3, 3, 3, 1 query
# rows; 4, 4, 4, 2 slots); the MoE's prefill takes the replicated body
CASES.update({f"uneven-{a}": (a, (1, 4), "seq", 10, NO_DROPS, None)
              for a in ("qwen3-4b", "deepseek-v2-236b")})
# xLSTM with heads that do not fill whole ranks at model = 4: with 2 heads
# each rank's qkv columns lie inside one head (the mLSTM splits a head's
# value columns; two ranks touch each sLSTM head, one computes it); with 3
# heads ranks 1 and 2 straddle two heads (the mLSTM exchanges whole heads,
# the sLSTM runs a head on every rank that touches it)
CASES.update({f"heads{h}-xlstm-350m": ("xlstm-350m", (1, 4), "seq", 64, None,
                                       (h, h)) for h in (2, 3)})
STRADDLE = [n for n in CASES if n.startswith("heads")]
MOE_CASE = dict(arch="deepseek-v2-236b", shape=(1, 4), S=16, cf=1.25)
# (2, 2) routes each token batch over two model shards, which hold twice
# the pairs' room of (1, 4)'s; at 1.0 this batch still drops pairs
MOE_CF22 = 1.0


def moe22_config(shapes):
    cfg = shapes.reduced_config(MOE_CASE["arch"])
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CF22))


def case_config(shapes, name):
    """The case's reduced config (``shapes`` from either package)."""
    arch, _, _, _, cf, heads = CASES[name]
    cfg = shapes.reduced_config(arch)
    if cf is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads[0], n_kv_heads=heads[1])
    return cfg


def case_batch(cfg, S, seed=0):
    """The prompt (B, S) and the decode step's token (B, 1), numpy."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "embed_stub":
        batch["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    return batch, tok


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: v for k in sorted(tree)
                for n, v in flatten(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {n: v for i, t in enumerate(tree)
                for n, v in flatten(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def unflatten(flat):
    out = {}
    for path, v in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# The port's side: four gloo ranks
# ---------------------------------------------------------------------------

def _full(tree):
    """Every DTensor leaf of a cache tree gathered (a collective: all ranks
    call it), as numpy."""
    from repro_torch.models.layers import tree_map
    return tree_map(lambda t: t.full_tensor().numpy(), tree)


def _rank_main(rank, world, store_path, wdir, out):
    import torch.distributed as dist
    from repro_torch.configs import load_all, shapes
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models.moe import moe_apply, moe_stats, reset_moe_stats
    from repro_torch.models.sharding import (distribute, sharding_rules,
                                             spec_for)
    torch.set_num_threads(1)
    load_all()
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        for name, (arch, shape, mode, S, _, _) in CASES.items():
            cfg = case_config(shapes, name)
            mesh = make_host_mesh("cpu", shape)
            params = unflatten(dict(np.load(f"{wdir}/{name}.npz")))
            model = Model.from_params(
                cfg, lm_params_from_jax(cfg, params, mesh=mesh), mesh=mesh)
            batch, tok = case_batch(cfg, S)
            L.set_attn_sharding(mode)
            reset_moe_stats()
            try:
                logits, caches = model.prefill(
                    {k: torch.tensor(v) for k, v in batch.items()},
                    cache_len=S + EXTRA)
                got = {"prefill": logits.numpy()}
                got.update({f"cache/{k}": v for k, v in
                            flatten(_full(caches)).items()})
                logits, _ = model.decode_step(torch.tensor(tok), caches, S)
                got["decode"] = logits.numpy()
            finally:
                L.set_attn_sharding("seq")
            stats = moe_stats()
            n = torch.tensor([stats["ep_dispatch"], stats["ep_replicated"],
                              stats["dense"], stats["dropped"]])
            dist.all_reduce(n)
            got["stats"] = n.numpy()
            if rank == 0:
                np.savez(f"{out}/{name}.npz", **got)
        # the MoE alone at the config's capacity factor
        cfg = shapes.reduced_config(MOE_CASE["arch"])
        w = dict(np.load(f"{wdir}/moe.npz"))
        for name, shape in (("moe", MOE_CASE["shape"]), ("moe22", (2, 2))):
            mesh = make_host_mesh("cpu", shape)
            if name == "moe22":
                cfg = moe22_config(shapes)
            with sharding_rules(mesh):
                from repro_torch.models.moe import moe_defs
                defs = moe_defs(cfg)
                p = {k: distribute(torch.tensor(w[k]),
                                   spec_for(mesh, *defs[k].axes)) for k in defs}
                x = distribute(torch.tensor(w["x"]),
                               spec_for(mesh, "batch", None, None))
                reset_moe_stats()
                with torch.inference_mode():
                    y, aux = moe_apply(p, x, cfg=cfg)
                dropped = torch.tensor([moe_stats()["dropped"]])
                dist.all_reduce(dropped)
                y, aux = y.full_tensor(), aux.full_tensor()   # collectives
                if rank == 0:
                    np.savez(f"{out}/{name}.npz", y=y.numpy(), aux=aux.numpy(),
                             dropped=dropped.numpy())
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's side: this file as a script on four forced host devices
# ---------------------------------------------------------------------------

def _pad_jax_caches(caches, length):
    import jax.numpy as jnp
    out = {}
    for gk, groups in caches.items():
        out[gk] = {}
        for key, c in groups.items():
            out[gk][key] = c if key.endswith(":xattn") else {
                n: (jnp.pad(t, [(0, 0), (0, 0), (0, length - t.shape[2])]
                            + [(0, 0)] * (t.ndim - 3))
                    if n in ("k", "v", "c_kv") else t) for n, t in c.items()}
    return out


def _reference_drops(x, p, cfg, n_shards):
    """The pairs the reference's ``_moe_local`` drops at ``n_shards`` model
    shards and one data shard: its capacities and bucket-slot rule on its
    own routing of each shard's tokens (``_route``, ``bucket_slots``)."""
    import jax.numpy as jnp
    from repro.models.moe import _route, bucket_slots
    mo = cfg.moe
    Bx, S, d = x.shape
    s_loc = S // n_shards
    e_loc = mo.n_experts // n_shards
    t = Bx * s_loc
    cap1 = int(math.ceil(t * mo.top_k / n_shards * mo.capacity_factor))
    cap2 = int(math.ceil(n_shards * cap1 / e_loc * mo.capacity_factor))
    dropped = 0
    sent = [[] for _ in range(n_shards)]          # per receiving shard
    for j in range(n_shards):
        xf = jnp.asarray(x[:, j * s_loc:(j + 1) * s_loc].reshape(t, d))
        _, top_e, _ = _route(xf, jnp.asarray(p["router"]), mo)
        flat_e = np.asarray(top_e).reshape(-1)
        dest = flat_e // e_loc
        slot1 = np.asarray(bucket_slots(jnp.asarray(dest), n_shards))
        dropped += int((slot1 >= cap1).sum())
        for r in range(n_shards):
            buf = np.full(cap1, -1)
            keep = (dest == r) & (slot1 < cap1)
            buf[slot1[keep]] = flat_e[keep] % e_loc
            sent[r].append(buf)
    for r in range(n_shards):
        recv = np.concatenate(sent[r])
        eid = np.where(recv >= 0, recv, e_loc)
        slot2 = np.asarray(bucket_slots(jnp.asarray(eid), e_loc + 1))
        dropped += int(((slot2 >= cap2) & (recv >= 0)).sum())
    return dropped


def _reference_main(wdir, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import load_all, shapes
    from repro.models import Model
    from repro.models import layers as L
    from repro.models.moe import moe_apply
    from repro.models.sharding import sharding_rules
    load_all()

    def mesh_of(shape):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))

    def run(model, params, batch, tok, S, mesh):
        with sharding_rules(mesh):
            logits, caches = model.prefill(params, batch)
            dec, _ = model.decode_step(params, tok, _pad_jax_caches(
                caches, S + EXTRA), S)
        return np.asarray(logits), caches, np.asarray(dec)

    for name, (arch, shape, mode, S, _, _) in CASES.items():
        if not (name.startswith("ref14") or name in STRADDLE
                or name == "padded"
                or (name.startswith("own22") and mode == "seq"
                    and arch in MOE_ARCHS)):
            continue
        cfg = case_config(shapes, name)
        model = Model(cfg)
        params = jax.tree_util.tree_map(
            jnp.asarray, unflatten(dict(np.load(f"{wdir}/{name}.npz"))))
        batch, tok = case_batch(cfg, S)
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        tok = jnp.asarray(tok)
        got = {}
        if name.startswith("ref14") or name in STRADDLE:
            logits, caches, dec = run(model, params, batch, tok, S,
                                      mesh_of(shape))
            got = {"prefill": logits, "decode": dec}
            got.update({f"cache/{k}": np.asarray(v)
                        for k, v in flatten(caches).items()})
        elif name == "padded":
            L.set_attn_sharding("heads")
            try:
                with sharding_rules(mesh_of(shape)):
                    logits, _ = model.prefill(params, batch)
            finally:
                L.set_attn_sharding("seq")
            plain, _ = model.prefill(params, batch)
            got = {"prefill": np.asarray(logits), "plain": np.asarray(plain)}
        else:
            logits, _, dec = run(model, params, batch, tok, S, mesh_of(shape))
            plain, _, pdec = run(model, params, batch, tok, S, None)
            got = {"prefill": logits, "decode": dec, "plain_prefill": plain,
                   "plain_decode": pdec}
        np.savez(f"{out}/{name}.npz", **got)
    cfg = shapes.reduced_config(MOE_CASE["arch"])
    w = dict(np.load(f"{wdir}/moe.npz"))
    p = {k: jnp.asarray(v) for k, v in w.items() if k != "x"}
    with sharding_rules(mesh_of(MOE_CASE["shape"])):
        y, aux = moe_apply(p, jnp.asarray(w["x"]), cfg=cfg)
    np.savez(f"{out}/moe.npz", y=np.asarray(y), aux=np.asarray(aux),
             dropped=_reference_drops(w["x"], w, cfg, MOE_CASE["shape"][1]))
    # (1, 2) on two devices: the dispatch the port's (2, 2) runs once it
    # has gathered the batch over 'data'
    cfg = moe22_config(shapes)
    with sharding_rules(mesh_of((1, 2))):
        y, aux = moe_apply(p, jnp.asarray(w["x"]), cfg=cfg)
    np.savez(f"{out}/moe22.npz", y=np.asarray(y), aux=np.asarray(aux),
             dropped=_reference_drops(w["x"], w, cfg, 2))


# ---------------------------------------------------------------------------
# The run and the tests
# ---------------------------------------------------------------------------

def _draw(defs, rng):
    """Numpy weights for a tree of the reference's PDef leaves, drawn as
    ``init_from_defs`` draws them (std scale/√fan_in; zeros, ones)."""
    from repro.models.layers import is_pdef
    import jax
    leaves, treedef = jax.tree_util.tree_flatten(defs, is_leaf=is_pdef)
    out = []
    for pd in leaves:
        if pd.init == "zeros":
            out.append(np.zeros(pd.shape, np.float32))
        elif pd.init == "ones":
            out.append(np.ones(pd.shape, np.float32))
        else:
            fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
            std = pd.scale / math.sqrt(max(fan_in, 1))
            out.append((rng.standard_normal(pd.shape) * std).astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro.configs import load_all, shapes
    from repro.models import Model as JaxModel
    from repro.models.moe import moe_defs
    load_all()
    base = tmp_path_factory.mktemp("mesh")
    wdir, port, ref = (base / "weights", base / "port", base / "ref")
    for d in (wdir, port, ref):
        d.mkdir()
    for i, name in enumerate(CASES):
        cfg = case_config(shapes, name)
        params = _draw(JaxModel(cfg).param_defs(), np.random.default_rng(i))
        np.savez(wdir / f"{name}.npz", **flatten(params))
    cfg = shapes.reduced_config(MOE_CASE["arch"])
    rng = np.random.default_rng(99)
    w = _draw(moe_defs(cfg), rng)
    w["x"] = rng.standard_normal((B, MOE_CASE["S"], cfg.d_model)).astype(np.float32)
    np.savez(wdir / "moe.npz", **w)

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
        p.join(timeout=240)
    hung = [p for p in ranks if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(5)
    log, _ = proc.communicate(timeout=240)
    assert not hung, "a gloo rank did not finish within 240 s"
    assert all(p.exitcode == 0 for p in ranks), [p.exitcode for p in ranks]
    assert proc.returncode == 0, log.decode()[-3000:]

    def load(d, name):
        return dict(np.load(d / f"{name}.npz"))

    out = {name: (load(port, name), load(ref, name) if
                  (ref / f"{name}.npz").exists() else None)
           for name in list(CASES) + ["moe", "moe22"]}
    out["weights"] = wdir
    return out


@pytest.fixture(scope="module")
def plain(runs):
    """The port without a mesh, on each (2, 2) and padded case's weights:
    {name: (prefill logits, decode logits)}."""
    from repro_torch.configs import load_all, shapes
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import Model
    load_all()
    out = {}
    for name in CASES:
        if name.startswith("ref14"):
            continue
        cfg = case_config(shapes, name)
        S = CASES[name][3]
        params = unflatten(dict(np.load(runs["weights"] / f"{name}.npz")))
        model = Model.from_params(cfg, lm_params_from_jax(cfg, params),
                                  device="cpu")
        batch, tok = case_batch(cfg, S)
        logits, caches = model.prefill(
            {k: torch.tensor(v) for k, v in batch.items()}, cache_len=S + EXTRA)
        dec, _ = model.decode_step(torch.tensor(tok), caches, S)
        out[name] = (logits.numpy(), dec.numpy())
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference_at_1x4(runs, arch):
    got, want = runs[f"ref14-{arch}"]
    assert got["prefill"].shape == want["prefill"].shape
    assert _rel(got["prefill"], want["prefill"]) < REL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_reference_at_1x4(runs, arch):
    """Every prefill cache leaf: the port's (placed on the mesh, gathered
    here, its self-attention slots past the prompt zero) against the
    reference's group-stacked one."""
    got, want = runs[f"ref14-{arch}"]
    keys = [k for k in want if k.startswith("cache/")]
    assert keys
    for k in keys:
        _, gk, key, name = k.split("/")
        ref = want[k]
        for g in range(ref.shape[0]):
            mine = got[f"cache/{gk}/{g}/{key}/{name}"]
            if name in ("k", "v", "c_kv") and not key.endswith(":xattn"):
                assert not mine[:, S_REF:].any(), k
                mine = mine[:, :S_REF]
            assert mine.shape == ref[g].shape, k
            assert _rel(mine, ref[g]) < REL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_at_1x4(runs, arch):
    got, want = runs[f"ref14-{arch}"]
    assert _rel(got["decode"], want["decode"]) < REL


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("own22")])
def test_mesh_2x2_matches_no_mesh(runs, plain, name):
    got, _ = runs[name]
    prefill, decode = plain[name]
    assert _rel(got["prefill"], prefill) < REL
    assert _rel(got["decode"], decode) < REL
    if CASES[name][0] in MOE_ARCHS:
        ep_dispatch, ep_replicated, dense, dropped = got["stats"]
        assert ep_dispatch > 0 and ep_replicated > 0 and dense == 0
        assert dropped == 0


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reference_moe_data_axis_fault_shown(runs, plain, arch, step):
    """At (2, 2) the reference's expert-parallel MoE adds other rows'
    partial sums into each row: its logits sit off its own no-mesh logits
    by more than 0.1 of their max, while the port's sit within 1e-5 of the
    port's no-mesh logits."""
    name = f"own22-{arch}-seq"
    got, want = runs[name]
    assert _rel(want[step], want[f"plain_{step}"]) > 0.1
    mine = plain[name][0 if step == "prefill" else 1]
    assert _rel(got[step], mine) < REL


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("uneven")])
def test_uneven_shards_match_no_mesh(runs, plain, name):
    """A prompt and a cache whose lengths do not divide by the model axis:
    the port on (1, 4) equals its no-mesh path."""
    got, _ = runs[name]
    prefill, decode = plain[name]
    assert _rel(got["prefill"], prefill) < REL
    assert _rel(got["decode"], decode) < REL


@pytest.mark.parametrize("name", STRADDLE)
def test_straddled_heads_match_reference_and_no_mesh(runs, plain, name):
    """xLSTM's mLSTM and sLSTM with heads that do not divide the model
    axis: prefill and decode logits and every prefill cache leaf against
    the reference on (1, 4), and the logits against the port's no-mesh
    path."""
    got, want = runs[name]
    prefill, decode = plain[name]
    for step, mine in (("prefill", prefill), ("decode", decode)):
        assert got[step].shape == want[step].shape
        assert _rel(got[step], want[step]) < REL, step
        assert _rel(got[step], mine) < REL, step
    keys = [k for k in want if k.startswith("cache/")]
    assert keys
    for k in keys:
        _, gk, key, leaf = k.split("/")
        for g in range(want[k].shape[0]):
            mine = got[f"cache/{gk}/{g}/{key}/{leaf}"]
            assert mine.shape == want[k][g].shape, k
            assert _rel(mine, want[k][g]) < REL, k


def test_padded_heads_match_no_mesh(runs, plain):
    """H = 10, Hkv = 2 at model = 4: G = 5 padded to G' = 6; the port's
    'heads' mode equals its no-mesh path in prefill and decode."""
    from repro_torch.models.layers import _heads_padding
    assert _heads_padding(10, 2, 4) == 6
    got, _ = runs["padded"]
    prefill, decode = plain["padded"]
    assert _rel(got["prefill"], prefill) < REL
    assert _rel(got["decode"], decode) < REL


def test_reference_padded_heads_fault_shown(runs):
    """The reference pads ``wo`` with zero rows at the end
    (``src/repro/models/layers.py:346-348``) while its queries are padded
    within each KV group, so with Hkv > 1 padded and real heads meet the
    wrong ``wo`` rows: its 'heads' logits sit off its own no-mesh logits by
    far more than the tolerance (2.2e-2 of their max on these weights)."""
    _, want = runs["padded"]
    assert _rel(want["prefill"], want["plain"]) > 100 * REL


def test_moe_matches_reference_with_drops_at_1x4(runs):
    """The MoE alone at (1, 4) and capacity factor 1.25: the port's output
    and auxiliary loss equal the reference's, and it drops exactly as many
    pairs as the reference's rule does on the reference's routing."""
    got, want = runs["moe"]
    assert int(want["dropped"]) > 0
    assert int(got["dropped"][0]) == int(want["dropped"])
    assert _rel(got["y"], want["y"]) < REL
    assert abs(float(got["aux"]) - float(want["aux"])) <= REL * abs(float(want["aux"]))


def test_moe_drops_counted_once_at_2x2(runs):
    """The MoE alone at (2, 2) and capacity factor 1.0.  Both ranks of a
    ``model`` index gather the batch over ``data`` and dispatch the same
    tokens, so the port's dispatch is the reference's at (1, 2), where the
    reference has no data-axis fault: the outputs agree, and the dropped
    pairs, summed over the four ranks, equal the count of the reference's
    rule at two model shards (each pair counted once, not once per data
    rank)."""
    got, want = runs["moe22"]
    assert int(want["dropped"]) > 0
    assert int(got["dropped"][0]) == int(want["dropped"])
    assert _rel(got["y"], want["y"]) < REL


def test_expert_parallel_bodies_ran(runs):
    """Both EP bodies ran on every rank for each MoE architecture at
    (1, 4) (prefill dispatches, decode runs replicated), and the dense
    fallback never did."""
    for arch in MOE_ARCHS:
        ep_dispatch, ep_replicated, dense, _ = runs[f"ref14-{arch}"][0]["stats"]
        assert ep_dispatch >= 4 and ep_replicated >= 4 and dense == 0


if __name__ == "__main__":
    _reference_main(sys.argv[1], sys.argv[2])
