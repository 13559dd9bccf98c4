"""The port's MarginalEngine end to end on the CPU, against exact marginals and
the JAX package's reconstruction of the same measurements."""
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import reconstruct_all_batched as jax_reconstruct_batched
from repro.core import select_sum_of_variances as jax_sov
from repro.core import Domain as JDomain
from repro.core import all_kway as jax_all_kway

from repro_torch.convert import plan_arrays, plan_from_arrays
from repro_torch.core import (Domain, all_kway, exact_marginals_from_x,
                              measure, reconstruct_all_batched,
                              select_sum_of_variances)
from repro_torch.data.tabular import (marginals_from_records,
                                      mixture_marginals, synth_domain,
                                      synthetic_records)
from repro_torch.engine import MarginalEngine

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("sizes,k", [([4] * 5, 2), ([3, 5, 2, 7], 3)])
def test_release_within_six_sigma_and_equal_to_jax(sizes, k):
    jplan = jax_sov(jax_all_kway(JDomain.create(sizes), k, include_lower=True),
                    1.0)
    plan = plan_from_arrays(*plan_arrays(jplan))
    x = np.random.default_rng(0).integers(0, 9, plan.domain.universe_size())
    margs = exact_marginals_from_x(plan.domain, plan.cliques, x)
    eng = MarginalEngine(plan, device="cpu")
    tables, meas = eng.release(margs, torch.Generator().manual_seed(1))
    ref = jax_reconstruct_batched(jplan, meas, use_kernel=False)
    for c, var in zip(plan.workload.cliques, plan.variances_array()):
        assert tables[c].shape == (plan.domain.n_cells(c),)
        assert np.abs(tables[c] - margs[c]).max() <= 6 * math.sqrt(var), c
        scale = max(np.abs(ref[c]).max(), 1.0)
        assert np.abs(tables[c] - ref[c]).max() / scale < 1e-5, c
    assert eng.stats.measure_calls == eng.stats.reconstruct_calls == 1
    if len(set(sizes)) == 1:                     # batching collapsed work
        assert eng.stats.measure_signatures < len(plan.cliques)


def test_engine_serves_like_measure_and_reconstruct():
    plan = select_sum_of_variances(all_kway(Domain.create([3, 4, 2, 4]), 2), 5.0)
    x = np.random.default_rng(2).integers(0, 9, plan.domain.universe_size())
    margs = exact_marginals_from_x(plan.domain, plan.cliques, x)
    eng = plan.engine(device="cpu")
    tables, meas = eng.release(margs, torch.Generator().manual_seed(3))
    direct = measure(plan, margs, torch.Generator().manual_seed(3), device="cpu")
    direct_tables = reconstruct_all_batched(plan, direct, device="cpu")
    for c in plan.cliques:
        assert np.array_equal(meas[c].omega, direct[c].omega)
    for c in plan.workload.cliques:
        assert np.array_equal(tables[c], direct_tables[c])
    assert eng.stats.compile_warmups == 0          # nothing to build on the CPU
    rows = eng.chain_plans()
    assert len(rows) == eng.stats.fused_chains + eng.stats.fallback_chains
    assert all(r["fused"] and r["smem_bytes"] <= 232448 for r in rows)
    nonneg, _ = eng.release(margs, torch.Generator(), postprocess="nonneg")
    assert eng.stats.postprocess_calls == 1
    assert all(np.all(nonneg[c] >= 0) for c in plan.workload.cliques)


def test_engine_counts_per_axis_chains():
    plan = select_sum_of_variances(
        all_kway(Domain.create([40, 40, 40, 3]), 3, include_lower=True), 1.0)
    eng = MarginalEngine(plan, device="cpu")
    assert eng.stats.fallback_chains == 2        # (40,40,40) measure + reconstruct
    assert not any(r["fused"] for r in eng.chain_plans() if r["dims"] == (40, 40, 40))


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    plan = select_sum_of_variances(all_kway(Domain.create([3, 4]), 2), 1.0)
    margs = {c: np.zeros(plan.domain.n_cells(c)) for c in plan.cliques}
    with pytest.raises(RuntimeError, match="CUDA"):
        MarginalEngine(plan)
    with pytest.raises(RuntimeError, match="CUDA"):
        measure(plan, margs, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        reconstruct_all_batched(plan, {})


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys; import repro_torch, repro_torch.core, repro_torch.engine,"
            " repro_torch.kernels.kron_matvec, repro_torch.kernels._build,"
            " repro_torch.convert, repro_torch.data, repro_torch.core.plus,"
            " repro_torch.engine.plus_engine, repro_torch.baselines,"
            " repro_torch.configs, repro_torch.configs.synth_ranges,"
            " repro_torch.kernels.autotune, repro_torch.roofline,"
            " repro_torch.core.accountant, repro_torch.core.dgauss,"
            " repro_torch.core.discrete, repro_torch.engine.discrete_engine,"
            " repro_torch.core.segment, repro_torch.release,"
            " repro_torch.release.consistency, repro_torch.release.nonneg,"
            " repro_torch.release.synth, repro_torch.obs,"
            " repro_torch.obs.metrics, repro_torch.obs.trace,"
            " repro_torch.obs.naming, repro_torch.core.partition,"
            " repro_torch.core.composite, repro_torch.engine.composite,"
            " repro_torch.engine.sharded, repro_torch.engine.corpus_stats,"
            " repro_torch.engine.multi, repro_torch.serve,"
            " repro_torch.serve.ledger, repro_torch.serve.pool,"
            " repro_torch.serve.stats, repro_torch.serve.server,"
            " repro_torch.launch, repro_torch.launch.serve,"
            " repro_torch.baselines.hdmm, repro_torch.baselines.svdb,"
            " repro_torch.configs.adult_marginals, repro_torch.analysis,"
            " repro_torch.analysis.astutils, repro_torch.analysis.findings,"
            " repro_torch.analysis.registry, repro_torch.analysis.privacy,"
            " repro_torch.analysis.locks, repro_torch.analysis.kernels,"
            " repro_torch.analysis.driver, repro_torch.analysis.__main__,"
            " repro_torch.models, repro_torch.models.config,"
            " repro_torch.models.layers, repro_torch.models.recurrent,"
            " repro_torch.models.moe, repro_torch.models.transformer,"
            " repro_torch.configs.shapes, repro_torch.data.tokens;"
            " repro_torch.configs.load_all();"
            " repro_torch.analysis.kernel_limits();"
            " bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'repro')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_mixture_marginals_are_marginals_of_one_table():
    dom = Domain.create([3, 4, 2])
    cl = [(), (0,), (1,), (0, 2), (0, 1, 2)]
    got = mixture_marginals(dom, cl, 1000.0, seed=4)
    x = got[(0, 1, 2)]
    assert x.sum() == pytest.approx(1000.0) and np.all(x > 0)
    want = exact_marginals_from_x(dom, cl, x)
    for c in cl:
        assert np.allclose(got[c], want[c], rtol=1e-12), c


def test_records_give_consistent_marginals():
    dom = synth_domain(4, 3)
    recs = synthetic_records(dom, 500, seed=1)
    assert recs.shape == (500, 3) and recs.max() < 4
    margs = marginals_from_records(dom, [(), (0,), (0, 1)], recs)
    assert margs[()][0] == 500
    assert np.array_equal(margs[(0, 1)].reshape(4, 4).sum(1), margs[(0,)])
