"""``repro_torch.models.sharding.exchange`` on four gloo ranks against numpy,
forward and backward, on the CPU.

Each case is a global (R, C) float64 array X of which rank r holds the
runs ``src[r]`` of dim ``a`` (and, when ``b`` is the other dim, all of
it); the exchange gives rank r the runs ``dst[r]`` of dim ``b`` (and all
of dim ``a``).  The ``dst`` runs are uneven, overlap, or are empty, as the
mixers' head exchanges make them when heads do not divide the ``model``
axis; equal runs gathered whole take the all-gather path.  Backward, each
rank's loss is sum(y_r * W_r): the gradient a rank receives is the sum,
over the ranks whose ``dst`` holds its rows, of their W_r, restricted to
its ``src`` rows.
"""
import datetime
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

R, C = 8, 10
# name -> (a, src, b, dst)
CASES = {
    "overlapping": (1, [(0, 3), (3, 5), (5, 9), (9, 10)],
                    1, [(0, 4), (2, 7), (6, 10), (0, 10)]),
    "empty": (1, [(0, 4), (4, 4), (4, 8), (8, 10)],
              1, [(0, 10), (3, 6), (5, 5), (1, 9)]),
    "whole": (1, [(0, 3), (3, 5), (5, 9), (9, 10)],
              1, [(0, 10)] * 4),
    "equal_whole": (0, [(0, 2), (2, 4), (4, 6), (6, 8)],
                    0, [(0, 8)] * 4),
    "cols_to_rows": (1, [(0, 3), (3, 5), (5, 9), (9, 10)],
                     0, [(0, 3), (3, 5), (5, 8), (8, 8)]),
    "rows_to_cols": (0, [(0, 1), (1, 4), (4, 6), (6, 8)],
                     1, [(0, 4), (2, 7), (6, 10), (7, 8)]),
}


def _global(i):
    return np.random.default_rng(i).standard_normal((R, C))


def _take(x, dim, run):
    return x[run[0]:run[1]] if dim == 0 else x[:, run[0]:run[1]]


def _weights(i, r, shape):
    return np.random.default_rng(1000 + 10 * i + r).standard_normal(shape)


def _expected(i, name):
    """({rank: y}, {rank: x's gradient}) in numpy."""
    a, src, b, dst = CASES[name]
    X = _global(i)
    ys = {r: _take(X, b, dst[r]) for r in range(4)}
    G = np.zeros_like(X)
    for r in range(4):
        lo, hi = dst[r]
        w = _weights(i, r, ys[r].shape)
        if b == 0:
            G[lo:hi] += w
        else:
            G[:, lo:hi] += w
    return ys, {r: _take(G, a, src[r]) for r in range(4)}


def _rank_main(rank, world, store_path, out):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.sharding import exchange
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh("cpu", (1, 4))
        got = {}
        for i, (name, (a, src, b, dst)) in enumerate(CASES.items()):
            x = torch.tensor(_take(_global(i), a, src[rank]),
                             requires_grad=True)
            y = exchange(x, mesh, ("model",), a, src, b, dst)
            w = torch.tensor(_weights(i, rank, tuple(y.shape)))
            (y * w).sum().backward()
            got[f"{name}/y"] = y.detach().numpy()
            got[f"{name}/grad"] = x.grad.numpy()
        np.savez(f"{out}/rank{rank}.npz", **got)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    base = tmp_path_factory.mktemp("exchange")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, 4, str(base / "store"), str(base)))
             for r in range(4)]
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
    return {r: dict(np.load(os.path.join(base, f"rank{r}.npz")))
            for r in range(4)}


@pytest.mark.parametrize("name", list(CASES))
def test_exchange_forward_and_backward(ranks, name):
    ys, grads = _expected(list(CASES).index(name), name)
    for r in range(4):
        assert ranks[r][f"{name}/y"].shape == ys[r].shape, r
        np.testing.assert_array_equal(ranks[r][f"{name}/y"], ys[r])
        assert ranks[r][f"{name}/grad"].shape == grads[r].shape, r
        np.testing.assert_allclose(ranks[r][f"{name}/grad"], grads[r],
                                   rtol=1e-12, atol=1e-12)
