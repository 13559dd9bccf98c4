"""Segment sums in a fixed order, and the planner routes built on them.

``Segments.sum`` must equal a float64 ``np.bincount`` (the oracle) to
rounding, ``gather``/``sum`` must be each other's adjoints in autograd, and
every route that uses them — the device max-variance loop and
``select_convex`` on ``device="cpu"``, the consistency CG — must return the
same bits on two calls.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Domain, all_kway, select_convex, select_max_variance
from repro_torch.core.plantable import plan_table
from repro_torch.core.segment import Segments


@pytest.mark.parametrize("n_entries,n,skew,tail", [
    (1000, 60, 300, ()), (1, 3, 0, ()), (513, 1, 0, (2,)), (4096, 4096, 0, ()),
    (2000, 50, 1500, (3, 2)), (100_000, 50_000, 20_000, ()),
])
def test_sum_equals_bincount(n_entries, n, skew, tail):
    rng = np.random.default_rng(n_entries)
    seg = rng.integers(0, n, n_entries)
    seg[:skew] = n // 2                         # one long segment
    x = rng.standard_normal((n_entries,) + tail)
    s = Segments(torch.as_tensor(seg), n)
    got = s.sum(torch.as_tensor(x)).numpy().reshape(n, -1)
    flat = x.reshape(n_entries, -1)
    want = np.stack([np.bincount(seg, weights=flat[:, j], minlength=n)
                     for j in range(flat.shape[1])], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert all(w >= 1 for w, _, _ in s.buckets)
    if n == 50_000:      # a long segment among short ones: one bucket a width
        widths = [w for w, _, _ in s.buckets]
        assert widths[:2] == [1, 2] and widths[-1] == 32768
    y = rng.standard_normal((n,) + tail)
    assert np.array_equal(s.gather(torch.as_tensor(y)).numpy(), y[seg])


def test_gradients_are_each_others_adjoint():
    rng = np.random.default_rng(1)
    seg = torch.as_tensor(rng.integers(0, 9, 200))
    s = Segments(seg, 12)                       # three targets stay empty
    x = torch.tensor(rng.standard_normal(200), requires_grad=True)
    y = torch.tensor(rng.standard_normal(12), requires_grad=True)
    assert torch.autograd.gradcheck(s.sum, (x,))
    assert torch.autograd.gradcheck(s.gather, (y,))
    (s.sum(x) * y).sum().backward()
    assert torch.equal(x.grad, y.detach()[seg])
    assert torch.equal(y.grad, s.sum(x.detach()))


def test_empty_and_bad_segments():
    s = Segments(torch.zeros(0, dtype=torch.int64), 4)
    assert torch.equal(s.sum(torch.zeros(0)), torch.zeros(4))
    with pytest.raises(ValueError, match="segment ids"):
        Segments(torch.tensor([0, 5]), 5)
    with pytest.raises(ValueError, match="entries"):
        Segments(torch.tensor([0, 1]), 2).sum(torch.zeros(3))


def _adult_like():
    return all_kway(Domain.create([6, 5, 4, 3, 2]), 3, include_lower=True)


def test_device_planner_routes_repeat_bit_for_bit_on_cpu():
    wk = _adult_like()
    a = select_max_variance(wk, 1.0, backend="device", device="cpu", iters=300)
    b = select_max_variance(wk, 1.0, backend="device", device="cpu", iters=300)
    assert np.array_equal(a.sigma, b.sigma) and np.array_equal(a.mu, b.mu)

    def l2(var):
        return torch.sqrt(torch.sum(var * var))
    for loss in ("max_variance", l2):
        c = select_convex(wk, 1.0, loss=loss, steps=200, device="cpu")
        d = select_convex(wk, 1.0, loss=loss, steps=200, device="cpu")
        assert np.array_equal(c.sigma, d.sigma)
        assert c.loss_value == d.loss_value


def test_planner_segments_match_the_incidence():
    t = plan_table(_adult_like())
    rows, cols = t.device_segments("cpu")
    assert (rows.n_entries, rows.n) == (t.inc_vals.size, t.m)
    assert (cols.n_entries, cols.n) == (t.inc_vals.size, t.n)
    sig = np.linspace(1.0, 2.0, t.n)
    var = rows.sum(torch.as_tensor(t.inc_vals * sig[t.inc_cols])).numpy()
    np.testing.assert_allclose(var, t.variances(sig), rtol=1e-13)
    assert t.device_segments("cpu") is t.device_segments("cpu")     # cached
