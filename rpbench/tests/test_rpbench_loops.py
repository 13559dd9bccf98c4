"""Both loop kinds, through a whole run on the CPU at a tiny size."""
from __future__ import annotations

import pytest


@pytest.mark.parametrize("trace", [0, 1])
def test_release_loop(bench, tiny_cell, trace):
    res, lines = bench.run_cell(tiny_cell("release"), 2 ** 33 + 5, 0.4,
                                bool(trace), device="cpu", log=lambda m: None)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 1
    assert [ln.split()[1] for ln in lines] == ["sigma2_rel", "omega_rel",
                                               "table_rel"]
    assert list(res)[-1] == "checks"
    assert {"startup_s", "plan_s", "engine_build_s", "warm_release_s"} <= set(res["setup"])
    assert isinstance(res["setup"]["first_in_checkout"], bool)
    names = set(res["metrics"])
    if trace:
        assert {"plan_s", "engine_build_s", "measure_ms.release",
                "reconstruct_ms.release", "release_p95_ms"} <= names
        assert res["device"]["window_s"] > 0 and "breakdown" in res
    else:
        # no card: no device peak, so no peak_device_gib
        assert names == {"setup_s", "release_cells_per_s"}
    assert res["device"]["platform"] == "cpu"


def test_served_closed_loop(bench, tiny_cell):
    cell = tiny_cell("serve16", tenants=2, clients_per_tenant=2, fsync=False)
    res, _ = bench.run_cell(cell, 77, 0.5, False, device="cpu",
                            log=lambda m: None)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 4
    assert res["metrics"]["release_cells_per_s"]["value"] > 0


def test_served_loop_with_the_ledger_fsynced(bench, tiny_cell, tmp_path):
    cell = tiny_cell("serve16", tenants=2, clients_per_tenant=1)
    assert cell.traffic["fsync"] is True
    res, _ = bench.run_cell(cell, 78, 0.3, False, device="cpu",
                            log=lambda m: None, root=bench.ROOT)
    assert res["correct"] and res["failed"] == 0


def test_same_seed_same_inputs_and_noise_seeds(bench, tiny_cell):
    """The seed fixes the inputs and the noise seeds: two runs of one seed
    check the same plan and answer with the same readings."""
    a, _ = bench.run_cell(tiny_cell(), 9, 0.2, False, device="cpu",
                          log=lambda m: None)
    b, _ = bench.run_cell(tiny_cell(), 9, 0.2, False, device="cpu",
                          log=lambda m: None)
    assert a["checks"]["sigma2_rel"] == b["checks"]["sigma2_rel"]
    from rpbench.harness import inputs
    m1 = inputs.make_marginals({"kind": "mixture", "mass": 1e4}, [3, 4, 5],
                               [(0, 1), (1, 2)], inputs.seed_int(2 ** 40, 100))
    m2 = inputs.make_marginals({"kind": "mixture", "mass": 1e4}, [3, 4, 5],
                               [(0, 1), (1, 2)], inputs.seed_int(2 ** 40, 100))
    assert all((m1[c] == m2[c]).all() for c in m1)
