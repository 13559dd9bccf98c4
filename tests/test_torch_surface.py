"""The port's public surface against the JAX package's, name for name.

Every module under ``src/repro/`` is read with ``ast`` (never imported) for
its public names: top-level functions and classes, the public methods of
public classes, module-level upper-case constants, and every name an
``__init__.py`` imports.  Each must exist in the namesake module of
``repro_torch`` (``repro.core.residual`` -> ``repro_torch.core.residual``),
found by ``importlib`` and ``hasattr``.

``JAX_ONLY`` is the one exception: a name (or, for a whole module, a module)
with no namesake in the port, mapped to the port's counterpart, which must
itself resolve.  The keys are dotted reference paths, the values dotted port
paths.
"""
import ast
import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REF_ROOT = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro"

JAX_ONLY = {
    # Pallas interpret mode off the TPU -> the port runs on CUDA unless the
    # caller asks for the CPU.
    "repro.kernels.kron_matvec._layout.interpret_default":
        "repro_torch.kernels.kron_matvec._layout.resolve_device",
    # The TPU's VMEM budget -> the shared memory one Hopper block may use.
    "repro.kernels.kron_matvec.fused.default_vmem_budget":
        "repro_torch.kernels.kron_matvec.fused._SMEM_BUDGET",
    # TPU sublane tiling of a dtype -> a CUDA kernel tiles no sublanes; the
    # port's limits are its shared-memory and operand-type fields.
    "repro.analysis.registry.KernelLimits.sublane_for":
        "repro_torch.analysis.registry.KernelLimits",
    # jax.ShapeDtypeStruct trees -> the dry run's fake tensors.
    "repro.models.layers.shape_structs_from_defs":
        "repro_torch.launch.dryrun._fake_tree",
    "repro.models.transformer.Model.param_shapes":
        "repro_torch.launch.dryrun._fake_tree",
    "repro.models.transformer.cache_shape_structs":
        "repro_torch.launch.dryrun.build_step",
    "repro.models.cache_shape_structs":
        "repro_torch.launch.dryrun.build_step",
    # Reading compiled HLO text -> counting eager work on fake tensors.
    "repro.launch.dryrun.collective_bytes_from_hlo":
        "repro_torch.roofline.op_stats.OpStats",
    "repro.launch.dryrun.build_cell":
        "repro_torch.launch.dryrun.count_step",
    "repro.roofline.hlo_stats":
        "repro_torch.roofline.op_stats",
    "repro.roofline.hlo_stats.Computation":
        "repro_torch.roofline.op_stats.OpStats",
    "repro.roofline.hlo_stats.parse_hlo":
        "repro_torch.roofline.op_stats.OpStats",
    "repro.roofline.hlo_stats.hlo_stats":
        "repro_torch.roofline.op_stats.op_stats",
    # The TPU v5e rates and the artifact directory read at import ->
    # the H100 row of DEVICE_TABLE and artifact_dir() read at call time.
    "repro.roofline.analyze.HW":
        "repro_torch.roofline.analyze.DEFAULT_DEVICE",
    "repro.roofline.HW":
        "repro_torch.roofline.analyze.DEFAULT_DEVICE",
    "repro.roofline.analyze.ARTIFACT_DIR":
        "repro_torch.roofline.analyze.artifact_dir",
}


def _ref_modules():
    """``{dotted reference module: path}`` of every module under src/repro."""
    out = {}
    for path in sorted(REF_ROOT.rglob("*.py")):
        parts = path.relative_to(REF_ROOT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts)] = path
    return out


REF_MODULES = _ref_modules()


def public_names(path: pathlib.Path):
    """The public names of one reference module, read with ``ast``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    init = path.name == "__init__.py"
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(
                    f"{node.name}.{sub.name}" for sub in node.body
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not sub.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(t.id for t in targets if isinstance(t, ast.Name)
                         and t.id.isupper() and not t.id.startswith("_"))
        elif init and isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                if name != "*" and not name.startswith("_"):
                    names.add(name)
    return names


def port_module(ref_module: str) -> str:
    return JAX_ONLY.get(ref_module,
                        "repro_torch" + ref_module[len("repro"):])


def resolve(dotted: str):
    """The object a dotted port path names: the longest prefix that imports
    as a module, then attributes down the rest.  Raises when it does not
    resolve."""
    parts = dotted.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ModuleNotFoundError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def has_path(obj, dotted: str) -> bool:
    for attr in dotted.split("."):
        if not hasattr(obj, attr):
            return False
        obj = getattr(obj, attr)
    return True


def test_reference_modules_found():
    assert "repro.core.residual" in REF_MODULES
    assert len(REF_MODULES) > 50


@pytest.mark.parametrize("ref_module", sorted(REF_MODULES))
def test_port_has_every_public_name(ref_module):
    """Each public name of the reference module exists in its namesake in
    the port, or is in JAX_ONLY with a counterpart that resolves (and then
    the namesake does not have it, else the exemption is stale)."""
    mod = importlib.import_module(port_module(ref_module))
    missing, stale = [], []
    for name in sorted(public_names(REF_MODULES[ref_module])):
        key = f"{ref_module}.{name}"
        present = has_path(mod, name)
        if key in JAX_ONLY:
            resolve(JAX_ONLY[key])
            if present:
                stale.append(name)
        elif not present:
            missing.append(name)
    assert not missing, (f"{mod.__name__} lacks {missing} of {ref_module}; "
                         "port them or add them to JAX_ONLY with their "
                         "counterpart")
    assert not stale, f"JAX_ONLY exempts {stale}, which {mod.__name__} has"


@pytest.mark.parametrize("key", sorted(JAX_ONLY))
def test_jax_only_entry_is_live(key):
    """Every exemption names a module or a public name the reference still
    has, and its counterpart resolves in the port."""
    if key in REF_MODULES:
        namesake = "repro_torch" + key[len("repro"):]
        assert importlib.util.find_spec(namesake) is None, (
            f"{namesake} exists: drop {key} from JAX_ONLY")
    else:
        ref_module = next(m for m in sorted(REF_MODULES, key=len, reverse=True)
                          if key.startswith(m + "."))
        assert key[len(ref_module) + 1:] in public_names(REF_MODULES[ref_module])
    assert JAX_ONLY[key].startswith("repro_torch.")
    resolve(JAX_ONLY[key])


# ------------------------------------------------ the names this surface added

@pytest.mark.parametrize("package", [
    "repro_torch", "repro_torch.core", "repro_torch.data",
    "repro_torch.kernels.kron_matvec", "repro_torch.roofline",
    "repro_torch.models", "repro_torch.engine"])
def test_package_imports_without_jax(package):
    """A fresh interpreter imports the package without jax or the JAX
    package, and without an import cycle."""
    code = (f"import sys, {package}; "
            "bad = [m for m in ('jax', 'repro') if m in sys.modules]; "
            "sys.exit(f'imported {bad}' if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REF_ROOT.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_new_exports():
    from repro_torch.core import (expand_marginal, expand_residual,  # noqa: F401
                                  marginal_factors, residual_factors)
    from repro_torch.data import (CPS_SIZES, LOANS_SIZES, cps_domain,
                                  loans_domain, synthetic_lm_batches)
    from repro_torch.kernels.kron_matvec import fused_cache_info  # noqa: F401
    from repro_torch.roofline import (analyze_all, analyze_cell,  # noqa: F401
                                      artifact_dir)
    assert cps_domain().sizes == tuple(CPS_SIZES)
    assert loans_domain().sizes == tuple(LOANS_SIZES)
    batch = next(synthetic_lm_batches(64, 2, 8, seed=0))
    assert batch["tokens"].shape[0] == 2


def test_fused_cache_info_counts_plans():
    from repro_torch.kernels.kron_matvec import fused_cache_info, plan_chain
    facs, dims = [np.ones((2, 3), np.float32), None], (3, 5)
    before = fused_cache_info()
    plan_chain(facs, dims, batch=7919)
    mid = fused_cache_info()
    plan_chain(facs, dims, batch=7919)
    after = fused_cache_info()
    assert mid.misses == before.misses + 1
    assert after.hits == mid.hits + 1 and after.misses == mid.misses


@pytest.mark.parametrize("fshapes,in_dims", [
    ([(9, 10), (9, 10), (9, 10)], (10, 10, 10)),
    ([None, (1, 7), (4, 3)], (5, 7, 3)),
    ([(99, 100), None], (100, 85)),
])
def test_cost_model_chain_flops(fshapes, in_dims):
    """The method is the module function, and both equal the JAX package's
    count on chains without an epilogue (the packages count a 'cumsum'
    epilogue differently)."""
    from repro.roofline.cost_model import CostModel as JCostModel
    from repro.roofline.cost_model import DEVICE_TABLE as JTABLE
    from repro_torch.roofline import CostModel, chain_flops, device_spec
    got = CostModel(device_spec("NVIDIA H100 80GB HBM3")).chain_flops(
        in_dims, fshapes)
    assert got == chain_flops(in_dims, fshapes)
    ref = JCostModel(next(iter(JTABLE.values()))).chain_flops(in_dims, fshapes)
    assert got == ref


def test_chain_cost_as_dict():
    from repro_torch.kernels.kron_matvec import plan_chain
    from repro_torch.roofline import CostModel, device_spec
    plan = plan_chain([np.ones((9, 10), np.float32)] * 3, (10, 10, 10),
                      batch=1000)
    cost = CostModel(device_spec("NVIDIA H100 80GB HBM3")).chain_cost(plan,
                                                                       1000)
    d = cost.as_dict()
    assert d == {"flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
                 "intensity": round(cost.intensity, 3), "blocks": cost.blocks,
                 "smem_bytes": cost.smem_bytes, "fits": cost.fits,
                 "slowdown": cost.slowdown, "predicted_s": cost.predicted_s}
    json.dumps(d)


def test_model_param_defs_and_axes():
    from repro_torch.configs.shapes import reduced_config
    from repro_torch.models.layers import PDef, axes_from_defs, is_pdef
    from repro_torch.models.transformer import Model, model_defs
    cfg = reduced_config("qwen3-4b")
    model = Model.init(cfg, device="cpu")
    defs = model.param_defs()
    assert defs == model_defs(cfg)
    axes = model.param_axes()
    assert axes == axes_from_defs(defs)
    assert is_pdef(PDef((2, 3), (None, None))) and not is_pdef((2, 3))
    assert not is_pdef(defs)
    assert axes["lm_head"] == defs["lm_head"].axes
