"""The plain reference against the program's own float64 paths on the CPU,
and its copies of the program's generators."""
from __future__ import annotations

import numpy as np
import pytest
import torch

ADULT = [100, 100, 100, 99, 85, 42, 16, 15, 9, 7, 6, 5, 2, 2]


@pytest.mark.parametrize("sizes", [[3, 4, 5, 2, 3], ADULT])
def test_plan_equals_the_programs(bench, sizes):
    from rpbench.harness import inputs
    from rpbench.reference import release_ref as ref
    plan = bench.program_planner(sizes, 3, True, {"objective": "sum_of_variances",
                                                  "budget": 1.0})
    wl = inputs.workload_cliques(len(sizes), 3, True)
    cl, sig = ref.sov_sigma2(sizes, wl, 1.0)
    assert cl == list(plan.cliques) == inputs.closure(wl)
    got = np.array([plan.sigmas[c] for c in cl])
    assert np.max(np.abs(got - sig) / sig) < 1e-12


def test_noise_is_the_programs_draw(bench):
    from repro_torch.core.mechanism import draw_noise
    from rpbench.reference import release_ref as ref
    sizes = [3, 4, 5, 2, 3]
    plan = bench.program_planner(sizes, 3, True, {"objective": "sum_of_variances",
                                                  "budget": 1.0})
    z = ref.draw_noise(sizes, list(plan.cliques), 2 ** 35 + 1, "cpu")
    want = draw_noise(plan, torch.Generator().manual_seed(2 ** 35 + 1), "cpu")
    assert torch.equal(z, want)


def test_release_equals_the_programs_plain_path(bench):
    """The program's plain (float32) measure and its float64 host oracle
    reconstruct, on the same noise, against the reference: float32
    rounding apart."""
    from repro_torch.core.mechanism import measure
    from repro_torch.core.reconstruct import reconstruct_all
    from rpbench.harness import check, inputs
    sizes = [3, 4, 5, 2, 3]
    plan = bench.program_planner(sizes, 3, True, {"objective": "sum_of_variances",
                                                  "budget": 1.0})
    wl = inputs.workload_cliques(len(sizes), 3, True)
    margs = inputs.make_marginals({"kind": "records", "records": 500}, sizes,
                                  inputs.closure(wl), 4)
    meas = measure(plan, margs, torch.Generator().manual_seed(12),
                   use_kernel=False, device="cpu")
    tables = reconstruct_all(plan, meas)
    chk = check.ReleaseCheck(sizes, wl, 1.0, "cpu")
    om, tab = chk.gaps(margs, 12, {c: m.omega for c, m in meas.items()}, tables)
    assert om < 1e-6 and tab < 1e-6


def test_records_copy_equals_the_programs():
    from repro_torch.core.domain import Domain
    from repro_torch.data.tabular import (marginals_from_records,
                                          mixture_marginals, synthetic_records)
    from rpbench.harness import inputs
    sizes = [5, 3, 4, 2]
    dom = Domain.create(sizes)
    recs = inputs.synthetic_records(sizes, 300, 7)
    assert np.array_equal(recs, synthetic_records(dom, 300, 7))
    cl = inputs.closure(inputs.workload_cliques(4, 3, True))
    a = inputs.marginals_from_records(sizes, cl, recs)
    b = marginals_from_records(dom, cl, recs)
    assert all(np.array_equal(a[c], b[c]) for c in cl)
    a = inputs.mixture_marginals(sizes, cl, 1e5, 3)
    b = mixture_marginals(dom, cl, 1e5, 3)
    assert all(np.array_equal(a[c], b[c]) for c in cl)


def test_seed_streams_differ_and_take_large_seeds():
    from rpbench.harness import inputs
    s = {inputs.seed_int(2 ** 33 + 9, k) for k in range(4)}
    assert len(s) == 4 and all(0 <= x < 2 ** 63 for x in s)
