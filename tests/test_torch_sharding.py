"""The port's sharding rules (``repro_torch.models.sharding``) and meshes
(``repro_torch.launch.mesh``) against the JAX package's, on the CPU with no
process group.

* ``_resolve`` gives the reference's PartitionSpec for every parameter and
  cache def of all ten architectures at their published sizes, under the
  axis names of both production meshes (the reference is handed a stub
  with ``axis_names``; no 256 devices needed).
* The placements of a spec: ``Shard`` on each mesh dim a tensor dim is
  split over, ``Replicate`` elsewhere.
* ``_heads_padding`` equals the reference's over a grid of (H, Hkv, msize).
* ``moe_apply`` without a mesh is the dense fallback, equal to the
  reference's (rel 1e-5), and counts itself as such.
* Importing the two modules loads no ``jax`` or ``repro`` module; the mesh
  entry points raise without a process group; ``logical`` is a no-op on a
  plain tensor and outside a mesh context; the mesh regions refuse rules
  other than ``DEFAULT_RULES``.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import load_all as jax_load_all
from repro.configs import shapes as jshapes
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import sharding as jsharding
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCH_IDS, load_all
from repro_torch.configs import shapes
from repro_torch.launch import mesh as tmesh
from repro_torch.models import get_config, layers, moe, sharding, transformer

jax_load_all()
load_all()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = {"single-pod": ("data", "model"),
          "multi-pod": ("pod", "data", "model")}


def _pdefs(tree):
    """(path, PDef) of a tree of PDef leaves (dicts and lists)."""
    if isinstance(tree, layers.PDef):
        return [("", tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [(f"{k}/{p}", pd) for k, v in items for p, pd in _pdefs(v)]


def _jax_pdefs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=jlayers.is_pdef)[0]
    return [(jax.tree_util.keystr(p), pd) for p, pd in leaves]


@pytest.mark.parametrize("axis_names", MESHES.values(), ids=MESHES.keys())
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_matches_reference_on_production_meshes(arch, axis_names):
    """The port's ``_resolve`` of every parameter and cache def's axes (both
    packages' trees) equals the reference's PartitionSpec."""
    from repro.models.config import get_config as jget_config
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    stub = SimpleNamespace(axis_names=axis_names)
    axes = {pd.axes for tree in (transformer.model_defs(cfg),
                                 transformer.cache_defs(cfg, 4, 64))
            for _, pd in _pdefs(tree)}
    axes |= {pd.axes for tree in (jtransformer.model_defs(jcfg),
                                  jtransformer.cache_defs(jcfg, 4, 64))
             for _, pd in _jax_pdefs(tree)}
    assert len(axes) > 5
    for names in axes:
        want = jsharding._resolve(names, stub, jsharding.DEFAULT_RULES)
        assert sharding._resolve(names, axis_names,
                                 sharding.DEFAULT_RULES) == tuple(want), names


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_axes_are_the_reference_axes_without_the_group_axis(arch):
    """Every port leaf carries the reference leaf's logical axes (the
    stacked group trees lose their leading group axis)."""
    from repro.models.config import get_config as jget_config
    cfg, jcfg = get_config(arch), jget_config(arch)
    for mine, ref, stacked in (
            (transformer.model_defs(cfg), jtransformer.model_defs(jcfg),
             ("blocks", "tail_blocks", "encoder_blocks")),
            (transformer.cache_defs(cfg, 2, 8),
             jtransformer.cache_defs(jcfg, 2, 8), ("blocks", "tail_blocks"))):
        want = {}
        for path, pd in _jax_pdefs(ref):
            keys = [k.strip("'") for k in path.strip("[]").split("][")]
            axes = pd.axes[1:] if keys[0] in stacked else pd.axes
            want["/".join(keys)] = axes
        got = {}
        for path, pd in _pdefs(mine):
            keys = path.rstrip("/").split("/")
            if keys[0] in stacked:
                keys = [keys[0]] + keys[2:]        # drop the group index
            got["/".join(keys)] = pd.axes
        assert got == want


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sharding.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert sharding.placements((None, None), mesh) == [Replicate()] * 3
    assert sharding.placements(("model", "data"), mesh) == [
        Replicate(), Shard(1), Shard(0)]
    with pytest.raises(ValueError, match="shards two dims"):
        sharding.placements(("model", "model"), mesh)


@pytest.mark.parametrize("n,parts", [(10, 4), (5, 4), (12, 4), (1, 2), (0, 3),
                                     (102400, 16)])
def test_chunk_bounds_split_as_torch_chunk(n, parts):
    sizes = [c.shape[0] for c in torch.arange(n).chunk(parts)] if n else []
    sizes += [0] * (parts - len(sizes))
    bounds = [sharding.chunk_bounds(n, parts, i) for i in range(parts)]
    assert [hi - lo for lo, hi in bounds] == sizes
    assert bounds[0][0] == 0 and bounds[-1][1] == n


def test_heads_padding_matches_reference():
    for H in range(1, 65):
        for Hkv in [h for h in range(1, H + 1) if H % h == 0]:
            for msize in (1, 2, 3, 4, 8, 16):
                assert layers._heads_padding(H, Hkv, msize) \
                    == jlayers._heads_padding(H, Hkv, msize), (H, Hkv, msize)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_moe_apply_without_a_mesh_is_the_dense_fallback(arch):
    cfg = shapes.reduced_config(arch)
    jcfg = jshapes.reduced_config(arch)
    p = jlayers.init_from_defs(jmoe.moe_defs(jcfg), jax.random.PRNGKey(3))
    x = np.random.default_rng(3).standard_normal((2, 8, cfg.d_model)) \
        .astype(np.float32)
    want, want_aux = jmoe.moe_apply(p, x, cfg=jcfg)
    moe.reset_moe_stats()
    got, aux = moe.moe_apply({k: torch.tensor(np.asarray(v)) for k, v in p.items()},
                             torch.tensor(x), cfg=cfg)
    assert moe.moe_stats() == {"ep_dispatch": 0, "ep_replicated": 0,
                               "dense": 1, "dropped": 0}
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))


def test_modules_import_neither_jax_nor_repro():
    code = ("import sys; import repro_torch.models.sharding, "
            "repro_torch.launch.mesh; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH="src"))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_mesh_entry_points_raise_without_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh("cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(device="cpu")
    fake = SimpleNamespace(device_type="cpu", mesh_dim_names=("data", "model"))
    with pytest.raises(RuntimeError, match="process group"):
        transformer.Model.init(shapes.reduced_config("qwen3-4b"),
                               torch.Generator().manual_seed(0), mesh=fake)


def test_logical_is_a_no_op_on_plain_tensors_and_outside_a_mesh():
    x = torch.ones(2, 3)
    assert sharding.logical(x, "batch", None) is x
    assert sharding.current_mesh() is None and sharding.current_rules() is None
    fake = SimpleNamespace(mesh_dim_names=("data", "model"))
    with sharding.sharding_rules(fake, {"seq": "model"}):
        assert sharding.current_mesh() is fake
        assert sharding.current_rules()["seq"] == "model"
        assert sharding.current_rules()["batch"] == ("pod", "data")
        assert sharding.logical(x, "batch", "seq") is x
    assert sharding.current_mesh() is None
    spec = sharding.spec_for(fake, "batch", "vocab", None)
    assert spec.spec == ("data",) + ("model", None) and spec.mesh is fake
    assert sharding.param_spec(fake, ("experts", None, "expert_dff")).spec \
        == ("model", None, "data")
    assert sharding.batch_axis_names(fake) == ("data",)


@pytest.mark.parametrize("rules", [{"vocab": None}, {"kv_seq": ("data", "model")},
                                   {"batch": None}, {"expert_dff": None}])
def test_mesh_regions_refuse_other_rules(rules):
    """The regions refuse no rule set: each takes its mesh axes from the
    active rules (the reference's dry-run ``shape_rules`` among them)
    through ``rule_axes``, which gives every logical name the axes
    ``_resolve`` maps it to on the mesh, major first, and () where it is
    replicated; the default rules hold outside a context.  The guard
    that refused other rules is gone."""
    fake = SimpleNamespace(mesh_dim_names=("data", "model"))

    def axes(v):
        return () if v is None else (v,) if isinstance(v, str) else tuple(v)

    with sharding.sharding_rules(fake, rules):
        active = sharding.current_rules()
        for name in sharding.DEFAULT_RULES:
            want = sharding._resolve((name,), fake.mesh_dim_names, active)[0]
            assert sharding.rule_axes(name) == axes(want), name
        (name, value), = rules.items()
        assert sharding.rule_axes(name) == axes(value)
        assert sharding.batch_axis_names(fake) == sharding.rule_axes("batch")
    assert sharding.rule_axes("vocab", fake) == ("model",)
    assert sharding.batch_axis_names(fake) == ("data",)
    assert not hasattr(sharding, "require_default_rules")