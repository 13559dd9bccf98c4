"""The port's tuned chain path on the CPU: the narrow plain version of the fused
kernel, the cost model, the autotuner and its cache, and the engines' role-aware
registration, against the JAX package (tests/test_autotune.py's cases).

The JAX side runs its Pallas kernel in interpret mode.  Tolerances, of
max|reference|: narrow port vs narrow JAX 1e-2 (bf16) and 2e-3 (fp16), the
rounding points are the same but JAX's dot sums in another order; both
packages vs the float64 oracle 3e-2 (bf16) and 4e-3 (fp16), the bounds of
tests/test_autotune.py.  Every test gets its own registry and a cache
directory under ``tmp_path`` (both packages read ``REPRO_AUTOTUNE_CACHE``;
their file names differ).
"""
import json
import math
import threading

import numpy as np
import pytest
import torch

from repro.core import Domain as JDomain
from repro.core import MarginalWorkload as JWorkload
from repro.core import all_kway as jax_all_kway
from repro.core import reconstruct_all_batched as jax_reconstruct_batched
from repro.core import select_sum_of_variances as jax_sov
from repro.core.kron import kron_matvec_np
from repro.core.plus import PlusSchema as JPlusSchema
from repro.core.plus import select_plus as jax_select_plus
from repro.core.reconstruct import \
    cross_marginal_covariance_dense as jax_cross_cov
from repro.core.reconstruct import \
    reconstruct_marginal_fast as jax_reconstruct_fast
from repro.engine.plus_engine import PlusEngine as JPlusEngine
from repro.kernels.autotune import reset_registry as jax_reset_registry
from repro.kernels.kron_matvec.fused import fused_chain_matvec as jax_fused

from repro_torch.convert import (plan_arrays, plan_from_arrays,
                                 plus_plan_arrays, plus_plan_from_arrays)
from repro_torch.core import (cross_marginal_covariance_dense,
                              exact_marginals_from_x, measure,
                              reconstruct_marginal_fast)
from repro_torch.core.residual import sub_matrix
from repro_torch.engine import MarginalEngine
from repro_torch.engine.plus_engine import PlusEngine
from repro_torch.kernels.autotune import (CACHE_VERSION, TunedConfig,
                                          TuningCache, autotune_mode,
                                          chain_key, pretune,
                                          registry_snapshot, reset_registry,
                                          resolve_config, tune_chain)
from repro_torch.kernels.kron_matvec import chain_stats, reset_chain_stats
from repro_torch.kernels.kron_matvec.fused import (config_launch,
                                                   factor_shapes,
                                                   fused_chain_matvec,
                                                   fused_chain_matvec_plain,
                                                   plan_chain)
from repro_torch.roofline import (DEVICE_TABLE, CostModel, DeviceSpec,
                                  detect_device, device_spec)

NARROW_VS_JAX = {"bfloat16": 1e-2, "float16": 2e-3}
NARROW_VS_ORACLE = {"bfloat16": 3e-2, "float16": 4e-3}
H100 = DEVICE_TABLE["nvidia h100 80gb hbm3"]


@pytest.fixture(autouse=True)
def _isolated_tuner(tmp_path, monkeypatch):
    """A fresh registry (both packages) and a throwaway cache directory."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "att"))
    monkeypatch.delenv("REPRO_KERNEL_COMPUTE_DTYPES", raising=False)
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "model")
    reset_registry()
    jax_reset_registry()
    yield
    reset_registry()
    jax_reset_registry()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _oracle(facs, dims, x, epilogue=None):
    full = [np.eye(n) if f is None else np.asarray(f, np.float64)
            for f, n in zip(facs, dims)]
    y = np.stack([kron_matvec_np(full, row.astype(np.float64), dims)
                  for row in x])
    out = [f.shape[0] for f in full]
    y = y.reshape((len(x),) + tuple(out))
    for axis, op in enumerate(epilogue or ()):
        if op == "cumsum":
            y = np.cumsum(y, axis=axis + 1)
    return y.reshape(len(x), -1)


def _rand_chain(rng, sizes):
    dims = tuple(int(s) for s in sizes)
    facs = []
    for n in dims:
        if rng.random() < 0.25:
            facs.append(None)
        else:
            facs.append(rng.standard_normal((int(rng.integers(1, n + 1)), n)))
    return facs, dims


# ------------------------------------------------------------ narrow operands
@pytest.mark.parametrize("cd", ["bfloat16", "float16"])
@pytest.mark.parametrize("epi", [None, ("cumsum",) * 3])
def test_narrow_plain_matches_jax_and_the_oracle(cd, epi):
    rng = np.random.default_rng(11)
    dims = (10, 10, 10)
    facs = [rng.standard_normal((10, 10)) for _ in dims]
    x = rng.standard_normal((40, 1000)).astype(np.float32)
    want = np.asarray(jax_fused(facs, x, dims, compute_dtype=cd, block_l=16,
                                epilogue=epi, interpret=True))
    reset_chain_stats()
    got = fused_chain_matvec(facs, torch.as_tensor(x), dims, epilogue=epi,
                             compute_dtype=cd)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert chain_stats()["fused_chains"] == 1
    assert chain_stats()["narrow_launches"] == 0       # nothing launched here
    assert _rel(got, want) < NARROW_VS_JAX[cd]
    plain = fused_chain_matvec_plain(
        [np.asarray(f, np.float32) for f in facs], torch.as_tensor(x), dims,
        epi, cd)
    assert torch.equal(plain, got)
    ref = _oracle(facs, dims, x, epi)
    assert _rel(got, ref) < NARROW_VS_ORACLE[cd]
    assert _rel(want, ref) < NARROW_VS_ORACLE[cd]
    # narrow is not float32: the rounding shows
    f32 = fused_chain_matvec(facs, torch.as_tensor(x), dims, epilogue=epi)
    assert not torch.equal(got, f32)


def test_narrow_plain_rounds_at_the_kernels_points():
    """Input and factors rounded to the operand type, each axis summed in
    float32 and rounded, the epilogue rounded after each axis, then widened."""
    rng = np.random.default_rng(12)
    dims = (3, 4)
    facs = [rng.standard_normal((2, 3)).astype(np.float32),
            rng.standard_normal((5, 4)).astype(np.float32)]
    x = torch.as_tensor(rng.standard_normal((6, 12)).astype(np.float32))
    bf = torch.bfloat16

    def r(t):
        return t.to(bf).float()

    s0, s1 = (r(torch.as_tensor(f)) for f in facs)
    t = r(x).view(6, 3, 4)
    t = r(torch.einsum("mn,bnr->bmr", s0, t))
    t = r(torch.einsum("mn,bln->blm", s1, t))
    want = r(torch.cumsum(t, 2)).reshape(6, -1)
    got = fused_chain_matvec_plain(facs, x, dims, (None, "cumsum"), "bfloat16")
    assert got.dtype == torch.float32
    assert torch.allclose(got, want, rtol=0,
                          atol=2 ** -7 * float(want.abs().max()))


def test_plan_chain_counts_bytes_by_itemsize():
    rng = np.random.default_rng(0)
    facs = [rng.standard_normal((3, 4)), rng.standard_normal((5, 5))]
    p32 = plan_chain(facs, (4, 5), batch=16, rows=8)
    pbf = plan_chain(facs, (4, 5), batch=16, rows=8, compute_dtype="bfloat16")
    p16 = plan_chain(facs, (4, 5), batch=16, rows=8,
                     compute_dtype=torch.float16)
    assert p32.smem_bytes == 4 * (p32.nf + 2 * 8 * p32.buf)
    assert pbf.smem_bytes == p16.smem_bytes == p32.smem_bytes // 2
    assert pbf.signature != p32.signature != p16.signature
    # a chain too wide for float32 fits at two bytes an element
    wide = [rng.standard_normal((32, 32))] * 3
    assert not plan_chain(wide, (32, 32, 32)).fused_ok
    narrow = plan_chain(wide, (32, 32, 32), compute_dtype="bfloat16")
    assert narrow.fused_ok and narrow.smem_bytes <= 232448
    # the default rows grow into the room a narrow type leaves
    f10 = [sub_matrix(10)] * 2
    assert plan_chain(f10, (10, 10), batch=10 ** 5,
                      smem_budget=20_000).rows < plan_chain(
        f10, (10, 10), batch=10 ** 5, smem_budget=20_000,
        compute_dtype="bfloat16").rows
    with pytest.raises(ValueError, match="compute dtype"):
        plan_chain(facs, (4, 5), compute_dtype="int8")


# ----------------------------------------------------------- bit-exactness
@pytest.mark.parametrize("seed", range(6))
def test_tuned_fp32_bit_identical_to_untuned(seed):
    """Rows are independent: any tuned rows give the untuned bits."""
    rng = np.random.default_rng(seed)
    facs, dims = _rand_chain(rng, rng.integers(2, 12, size=3))
    batch = int(rng.integers(1, 40))
    x = torch.as_tensor(rng.standard_normal((batch, math.prod(dims))),
                        dtype=torch.float32)
    untuned = fused_chain_matvec(facs, x, dims, smem_budget=232448)
    for spec in (DEVICE_TABLE["cpu"], H100):
        cfg = tune_chain(facs, dims, batch=batch, spec=spec, device="cpu",
                         persist=False)
        tuned = fused_chain_matvec(facs, x, dims, rows=cfg.rows,
                                   smem_budget=cfg.smem_budget)
        assert torch.equal(untuned, tuned)


def test_model_mode_identical_to_off(monkeypatch):
    rng = np.random.default_rng(7)
    facs, dims = _rand_chain(rng, (5, 4, 6))
    x = torch.as_tensor(rng.standard_normal((11, math.prod(dims))),
                        dtype=torch.float32)
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "off")
    y_off = fused_chain_matvec(facs, x, dims)
    assert not registry_snapshot("cpu")["entries"]
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "model")
    y_on = fused_chain_matvec(facs, x, dims)
    assert len(registry_snapshot("cpu")["entries"]) == 1
    assert torch.equal(y_off, y_on)


# --------------------------------------------------------------- the clamp
def test_narrow_config_is_replanned_at_fp32_without_allow_narrow(monkeypatch):
    """A tuned bf16 config whose rows overflow shared memory at four bytes
    an element serves a noise call at float32, re-planned whole: the plan
    fits and the bits are those of an explicit float32 call."""
    monkeypatch.setenv("REPRO_KERNEL_COMPUTE_DTYPES", "bfloat16")
    rng = np.random.default_rng(9)
    dims = (30, 30, 30)
    facs = [rng.standard_normal((30, 30)) for _ in dims]
    x = torch.as_tensor(rng.standard_normal((3, 27000)), dtype=torch.float32)
    narrow = plan_chain(facs, dims, batch=3, rows=2, compute_dtype="bfloat16")
    assert narrow.fused_ok
    assert not plan_chain(facs, dims, batch=3, rows=2).fused_ok
    cfg = TunedConfig(rows=2, smem_budget=narrow.smem_bytes,
                      compute_dtype="bfloat16", fused=True)
    fsh = factor_shapes(facs, dims)
    TuningCache("cpu").put(chain_key("cpu", dims, fsh, None, 3, ("bfloat16",)),
                           cfg.as_dict())
    got = resolve_config(facs, dims, 3, device="cpu")
    assert got.source == "cache" and got.rows == 2
    plan, fused = config_launch(fsh, dims, 3, None, got, allow_narrow=False)
    assert fused and plan.compute_dtype == "float32"
    assert plan.smem_bytes <= 232448 and plan.rows == 1
    clamped = fused_chain_matvec(facs, x, dims)
    assert torch.equal(clamped, fused_chain_matvec(facs, x, dims,
                                                   compute_dtype="float32"))
    served = fused_chain_matvec(facs, x, dims, allow_narrow=True)
    assert torch.equal(served, fused_chain_matvec(
        facs, x, dims, rows=2, compute_dtype="bfloat16"))
    assert not torch.equal(served, clamped)


# --------------------------------------------------------------- cost model
@pytest.mark.parametrize("name,kind,bw,peak", [
    ("NVIDIA H100 80GB HBM3", "nvidia h100 80gb hbm3", 3.35e12, 67e12),
    ("NVIDIA H100 PCIe", "nvidia h100 pcie", 2.0e12, 51e12),
    ("NVIDIA H100", "nvidia h100 80gb hbm3", 3.35e12, 67e12),
])
def test_device_spec_matches_h100_names(name, kind, bw, peak):
    spec = device_spec(name)
    assert spec.kind == kind and spec.hbm_bw == bw
    # the narrow rate is the fp32 FMA rate the kernel reaches
    assert spec.peak_flops == spec.peak_flops_f32 == peak
    assert spec.smem_limit == 232448
    other = device_spec("Some Other GPU")
    assert other.kind == "some other gpu" and other.hbm_bw == 3.35e12
    assert detect_device("cpu") is DEVICE_TABLE["cpu"]
    assert "gpu" not in DEVICE_TABLE


def test_fused_never_chosen_over_the_limit():
    tiny = DeviceSpec("tiny", peak_flops=1e12, peak_flops_f32=1e12,
                      hbm_bw=1e11, smem_limit=1024, launch_s=1e-6, sms=4,
                      smem_per_sm=2048)
    rng = np.random.default_rng(1)
    cfg = tune_chain([rng.standard_normal((64, 64))], (64,), batch=32,
                     spec=tiny, device="cpu", persist=False)
    assert cfg.fused is False
    # the whole Adult (100,100,100) chain: over the H100 block at any type
    big = [sub_matrix(100)] * 3
    cfg = tune_chain(big, (100, 100, 100), batch=2, spec=H100, device="cpu",
                     dtypes=("float32", "bfloat16"), persist=False)
    assert cfg.fused is False


def test_cost_model_charges_occupancy_not_block_count():
    model = CostModel(H100)
    full = 132 * 6
    # fewer blocks than SMs leave SMs idle
    assert model.occupancy_slowdown(10, 33200) > 10
    assert model.occupancy_slowdown(full * 50, 33200) == pytest.approx(1.0)
    # shared memory that allows one block an SM is charged
    assert model.blocks_per_sm(33200) == 6
    assert model.blocks_per_sm(200_000) == 1
    assert model.occupancy_slowdown(full * 50, 200_000) == pytest.approx(4.0)
    assert model.blocks_per_sm(232449) == 0
    # at full occupancy, halving rows costs only the extra factor staging
    facs = [sub_matrix(10)] * 3
    b = 161_700
    p2 = plan_chain(facs, (10, 10, 10), batch=b, rows=2)
    p4 = plan_chain(facs, (10, 10, 10), batch=b, rows=4)
    c2, c4 = model.chain_cost(p2, b), model.chain_cost(p4, b)
    staged = (c2.blocks - c4.blocks) * 4 * p4.nf / H100.hbm_bw
    assert 0 <= c2.predicted_s - c4.predicted_s <= 1.02 * staged
    # the epilogue is one add per output per axis, not a tril product
    pe = plan_chain(facs, (10, 10, 10), batch=b, rows=4,
                    epilogue=("cumsum",) * 3)
    assert model.chain_cost(pe, b).flops - c4.flops == 3 * 729 * b


def test_cpu_row_scores_fused_and_per_axis_alike():
    """The plain versions run the same operations on both routes: the
    tuner never leaves the fused route on the CPU for speed."""
    model = CostModel(DEVICE_TABLE["cpu"])
    facs = [sub_matrix(7), sub_matrix(5)]
    plan = plan_chain(facs, (7, 5), batch=30)
    assert model.chain_cost(plan, 30).predicted_s == pytest.approx(
        model.per_axis_cost((7, 5), plan.fshapes, 30))
    assert tune_chain(facs, (7, 5), batch=30, device="cpu").fused


def test_h100_model_keeps_the_default_rows_on_synth_chains():
    """model mode must not slow the main path: at Synth-10^100's 3-way
    chains the float32 pick is plan_chain's default."""
    for facs, batch in (([sub_matrix(10)] * 3, 323_400),
                        ([np.ones((10, 10))] * 3, 161_700)):
        cfg = tune_chain(facs, (10, 10, 10), batch=batch, spec=H100,
                         device="cpu", persist=False)
        assert cfg.fused and cfg.compute_dtype == "float32"
        assert cfg.rows == plan_chain(facs, (10, 10, 10), batch=batch).rows


# ------------------------------------------------------------- cache + env
def test_tuning_cache_round_trip(tmp_path):
    c = TuningCache("cpu", path=str(tmp_path / "t.json"))
    c.put("k1", {"rows": 64, "smem_budget": 123, "fused": True})
    c2 = TuningCache("cpu", path=str(tmp_path / "t.json"))
    assert c2.get("k1")["rows"] == 64
    assert c2.get("nope") is None


def test_tuning_cache_concurrent_puts(tmp_path):
    c = TuningCache("cpu", path=str(tmp_path / "t.json"))
    threads = [threading.Thread(target=c.put, args=(f"k{i}", {"rows": 8}))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(c.load()) == 16
    assert len(TuningCache("cpu", path=str(tmp_path / "t.json")).load()) == 16


def test_tuning_cache_invalidation(tmp_path):
    path = str(tmp_path / "t.json")
    TuningCache("cpu", path=path).put("k", {"rows": 64})
    assert TuningCache("nvidia h100 80gb hbm3", path=path).get("k") is None
    with open(path) as fh:
        blob = json.load(fh)
    blob["version"] = CACHE_VERSION + 1
    with open(path, "w") as fh:
        json.dump(blob, fh)
    assert TuningCache("cpu", path=path).get("k") is None
    with open(path, "w") as fh:
        fh.write("{not json")
    assert TuningCache("cpu", path=path).get("k") is None


def test_cache_files_are_the_ports_own(tmp_path):
    """One REPRO_AUTOTUNE_CACHE for both packages: distinct files."""
    from repro.kernels.autotune import TuningCache as JTuningCache
    assert TuningCache("cpu").path != JTuningCache("cpu").path
    assert TuningCache("cpu").path.startswith(str(tmp_path))


def test_resolve_config_reads_the_disk_cache_after_reset():
    rng = np.random.default_rng(5)
    facs = [rng.standard_normal((2, 6))]
    cfg = tune_chain(facs, (6,), batch=10, device="cpu")       # persists
    reset_registry()
    got = resolve_config(facs, (6,), batch=10, device="cpu")
    assert got.source == "cache"
    assert (got.rows, got.compute_dtype, got.fused) == \
        (cfg.rows, cfg.compute_dtype, cfg.fused)
    reset_registry()
    fresh = resolve_config(facs, (6,), batch=11, device="cpu")  # a miss
    assert fresh.source == "model"
    assert len(TuningCache("cpu").load()) == 1                  # not persisted


def test_mode_env_gate(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "off")
    assert autotune_mode() == "off"
    assert resolve_config([np.ones((2, 3))], (3,), batch=4, device="cpu") is None
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "bogus")
    assert autotune_mode() == "model"
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "measure")
    assert autotune_mode() == "measure"


def test_chain_key_discriminates():
    f = [(2, 3)]
    k1 = chain_key("cpu", (3,), f, None, 8)
    assert k1 == chain_key("cpu", (3,), f, (None,), 8, ("float32",))
    assert k1 != chain_key("cpu", (3,), f, None, 16)
    assert k1 != chain_key("cpu", (3,), [None], None, 8)
    assert k1 != chain_key("cpu", (3,), f, ("cumsum",), 8)
    assert k1 != chain_key("nvidia h100 80gb hbm3", (3,), f, None, 8)
    assert k1 != chain_key("cpu", (3,), f, None, 8, ("float32", "bfloat16"))


def test_pretune_and_measure_mode():
    rng = np.random.default_rng(8)
    chains = [([rng.standard_normal((2, 4))], (4,), 6, None),
              ([rng.standard_normal((3, 5)), None], (5, 2), 12,
               ("cumsum", None))]
    out = pretune(chains, device="cpu", mode="measure",
                  dtypes=("float32", "bfloat16"))
    assert len(out) == 2
    assert all(c.source == "measure" and c.predicted_s > 0 for c in out)
    assert len(TuningCache("cpu").load()) == 2
    assert all(c.rows >= 1 and c.blocks >= 1 for c in out)


# -------------------------------------------------------------- the engines
def _jax_and_port_plan(sizes, k):
    jplan = jax_sov(jax_all_kway(JDomain.create(list(sizes)), k,
                                 include_lower=True), 1.0)
    return jplan, plan_from_arrays(*plan_arrays(jplan))


def test_engine_registers_tuned_chains():
    jplan, plan = _jax_and_port_plan((3, 4, 5), 2)
    eng = MarginalEngine(plan, device="cpu")
    rows = eng.chain_plans()
    assert eng.stats.tuned_chains == len(rows) > 0
    assert eng.stats.fallback_chains == 0
    for row in rows:
        assert row["compute_dtype"] == "float32" and row["tuned"] is True
        assert row["tune_source"] == "model" and row["intensity"] > 0
    assert {r["role"] for r in rows} == {"measure", "reconstruct"}
    assert len(registry_snapshot("cpu")["entries"]) >= len(rows)


def test_engine_off_mode_untouched(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "off")
    _, plan = _jax_and_port_plan((3, 4), 2)
    eng = MarginalEngine(plan, device="cpu")
    assert eng.stats.tuned_chains == 0
    assert all(r["tuned"] is False and r["tune_source"] == "default"
               for r in eng.chain_plans())


def test_marginal_engine_serves_reconstruction_narrow(monkeypatch):
    """REPRO_KERNEL_COMPUTE_DTYPES=bfloat16: measure chains stay float32
    (measurements bit for bit those of off mode), reconstruct chains take
    bf16, and the tables match the JAX package's narrow kernel path on the
    same measurements within rel 1e-2."""
    jplan, plan = _jax_and_port_plan((3, 5, 4), 2)
    x = np.random.default_rng(0).integers(0, 9, plan.domain.universe_size())
    margs = exact_marginals_from_x(plan.domain, plan.cliques, x)
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "off")
    meas_off = measure(plan, margs, torch.Generator().manual_seed(1),
                       device="cpu")
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "model")
    monkeypatch.setenv("REPRO_KERNEL_COMPUTE_DTYPES", "bfloat16")
    eng = MarginalEngine(plan, device="cpu")
    rows = eng.chain_plans()
    assert all(r["compute_dtype"] == "float32" for r in rows
               if r["role"] == "measure")
    recon = [r for r in rows if r["role"] == "reconstruct"]
    assert recon and all(r["compute_dtype"] == "bfloat16" and r["fused"]
                         for r in recon)
    tables, meas = eng.release(margs, torch.Generator().manual_seed(1))
    for c in plan.cliques:
        assert np.array_equal(meas[c].omega, meas_off[c].omega), c
    again = MarginalEngine(plan, device="cpu").reconstruct(meas)
    ref = jax_reconstruct_batched(jplan, meas, use_kernel=True)
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "off")
    exact32 = MarginalEngine(plan, device="cpu").reconstruct(meas)
    narrowed = 0
    for c in plan.workload.cliques:
        scale = max(np.abs(ref[c]).max(), 1.0)
        assert np.abs(tables[c] - ref[c]).max() / scale < 1e-2, c
        assert np.array_equal(tables[c], again[c])
        narrowed += not np.array_equal(tables[c], exact32[c])
    assert narrowed > 0


def test_plus_engine_serves_reconstruction_narrow(monkeypatch):
    dom_sizes, kinds = (4, 3, 5), ["prefix", "identity", "range"]
    jdom = JDomain.create(list(dom_sizes))
    jschema = JPlusSchema.create(jdom, kinds, strategy_mode="hier")
    cliques = ((0,), (0, 2), (1, 2), (0, 1, 2))
    jplan = jax_select_plus(JWorkload(jdom, cliques), jschema, 1.0, "sov")
    plan = plus_plan_from_arrays(*plus_plan_arrays(jplan))
    x = np.random.default_rng(0).integers(0, 7, plan.domain.universe_size())
    margs = exact_marginals_from_x(plan.domain, plan.cliques, x.astype(float))
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "off")
    meas_off = PlusEngine(plan, device="cpu").measure(
        margs, torch.Generator().manual_seed(3))
    exact = PlusEngine(plan, device="cpu").reconstruct(meas_off)
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "model")
    monkeypatch.setenv("REPRO_KERNEL_COMPUTE_DTYPES", "bfloat16")
    eng = PlusEngine(plan, device="cpu")
    rows = eng.chain_plans()
    assert all(r["compute_dtype"] == "float32" for r in rows
               if r["role"] == "measure")
    assert all(r["compute_dtype"] == "bfloat16" for r in rows
               if r["role"] == "reconstruct")
    meas = eng.measure(margs, torch.Generator().manual_seed(3))
    for c in plan.cliques:
        assert np.array_equal(meas[c].omega, meas_off[c].omega), c
    tables = eng.reconstruct(meas)
    ref = JPlusEngine(jplan, use_kernel=True, precompile=False).reconstruct(meas)
    for c in plan.workload.cliques:
        scale = max(np.abs(ref[c]).max(), 1.0)
        assert np.abs(tables[c] - ref[c]).max() / scale < 1e-2, c
        assert np.abs(tables[c] - exact[c]).max() / scale < 3e-2, c


# ------------------------------------------------- reconstruct, the rest ported
def test_reconstruct_marginal_fast_and_cross_covariance_match_jax():
    jplan, plan = _jax_and_port_plan((3, 4, 2), 3)
    x = np.random.default_rng(4).integers(0, 5, plan.domain.universe_size())
    margs = exact_marginals_from_x(plan.domain, plan.cliques, x)
    meas = measure(plan, margs, torch.Generator().manual_seed(2), device="cpu")
    for c in plan.workload.cliques:
        want = jax_reconstruct_fast(jplan, meas, c)
        host = reconstruct_marginal_fast(plan, meas, c)
        assert np.allclose(host, want, rtol=1e-12, atol=1e-9), c
        kern = reconstruct_marginal_fast(plan, meas, c, use_kernel=True,
                                         device="cpu")
        assert kern.dtype == np.float32
        assert _rel(kern, want) < 2e-5, c
    for a, b in (((0, 1), (1, 2)), ((0,), (0, 1, 2)), ((), (2,)), ((0,), (1,))):
        got = cross_marginal_covariance_dense(plan, a, b)
        assert np.allclose(got, jax_cross_cov(jplan, a, b), rtol=1e-10,
                           atol=1e-12), (a, b)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _, plan = _jax_and_port_plan((3, 4), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        reconstruct_marginal_fast(plan, {}, (0, 1), use_kernel=True)
    assert detect_device() is DEVICE_TABLE["cpu"]


def test_tuner_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """tune_chain and pretune resolve a missing device as the engines do:
    CUDA, which raises without a card (no quiet fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    facs = [np.ones((2, 3))]
    with pytest.raises(RuntimeError, match="CUDA"):
        tune_chain(facs, (3,), batch=4, mode="model", persist=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pretune([(facs, (3,), 4, None)], mode="model")
    assert tune_chain(facs, (3,), batch=4, device="cpu", mode="model",
                      persist=False).fused
