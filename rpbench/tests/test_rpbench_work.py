"""The frozen chain counts against shapes worked out by hand."""
from __future__ import annotations

import pytest

from rpbench.harness import work

SUB10 = ((9, 10),) * 3


def test_bytes_of_a_synth_measure_chain():
    # 2 rows of 1000 in, 729 out, three 9x10 factors, float32
    assert work.chain_bytes((10, 10, 10), SUB10, 2) == 4 * (2 * 1729 + 3 * 90)


def test_flops_axis_by_axis():
    # 2*9*10*100 + 2*9*10*90 + 2*9*10*81, in any order of the axes
    assert work.least_chain_flops((10, 10, 10), SUB10) == 18000 + 16200 + 14580


def test_least_flops_takes_the_cheaper_order():
    shapes = ((2, 3), (99, 100))
    in_order = 2 * 2 * 3 * 100 + 2 * 99 * 100 * 2          # axis 0 first
    reversed_ = 2 * 99 * 100 * 3 + 2 * 2 * 3 * 99          # axis 1 first
    assert in_order < reversed_
    assert work.least_chain_flops((3, 100), shapes) == min(in_order, reversed_)


def test_release_chains_by_signature_group():
    sizes = [3, 4, 3]
    closure = [(), (0,), (1,), (2,), (0, 1), (1, 2)]
    workload = [(0,), (1,), (2,), (0, 1), (1, 2)]
    got = sorted(work.release_chains(sizes, closure, workload))
    assert got == sorted([
        ((3,), ((2, 3),), 2), ((4,), ((3, 4),), 1),
        ((3, 4), ((2, 3), (3, 4)), 1), ((4, 3), ((3, 4), (2, 3)), 1),
        ((3,), ((3, 3),), 2), ((4,), ((4, 4),), 1),
        ((3, 4), ((3, 3), (4, 4)), 1), ((4, 3), ((4, 4), (3, 3)), 1)])


@pytest.mark.parametrize("rate,bound", [(1e12, "bytes"), (1e3, "ops")])
def test_least_seconds_is_the_larger_bound(rate, bound):
    chain = ((10, 10, 10), SUB10, 2)
    peaks = {"hbm_bytes_per_s": 1e9, "fp32_flops_per_s": rate}
    t_mem = work.chain_bytes(*chain) / 1e9
    t_ops = 2 * work.least_chain_flops((10, 10, 10), SUB10) / rate
    assert work.least_seconds(chain, peaks) == max(t_mem, t_ops)
    assert (t_mem >= t_ops) == (bound == "bytes")


def test_synth_release_count():
    """Synth-10^100 <=3-way: 161,700 3-way cliques through ⊗Sub_10 (1000 in,
    729 out) and ⊗T_10 (1000 in, 1000 out), both bound by bytes."""
    from rpbench.harness import inputs
    sizes = [10] * 100
    wl = inputs.workload_cliques(100, 3, True)
    cl = inputs.closure(wl)
    peaks = work.PEAKS["NVIDIA H100 80GB HBM3"]
    chains = {(c[0], c[1][0]): c for c in work.release_chains(sizes, cl, wl)}
    meas = chains[((10, 10, 10), (9, 10))]
    rec = chains[((10, 10, 10), (10, 10))]
    assert meas[2] == rec[2] == 161700
    assert work.least_seconds(meas, peaks) == pytest.approx(
        4 * (161700 * 1729 + 270) / 3.35e12)
    assert work.least_seconds(rec, peaks) == pytest.approx(
        4 * (161700 * 2000 + 300) / 3.35e12)
