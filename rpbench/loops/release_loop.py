"""release_loop: one client releases the configuration's workload back to
back, each release from a fresh noise seed.

Each request is ``engine.release(marginals, gen)`` with ``postprocess=None``
and ``gen = torch.Generator(device).manual_seed(seed)``; the next one is
sent when the last returned (the tables come back as host arrays, so a
return is a completion).  Traffic parameters: none besides ``loop``.
Set-up builds the engine (``engine_build_s``) and warms it with one
release.
"""
from __future__ import annotations

import time

import torch

from rpbench.harness.spec import Done


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def setup(ctx):
    t = time.monotonic()
    engine = ctx.engine_factory(ctx.plan, ctx.device)
    ctx.setup["engine_build_s"] = time.monotonic() - t
    t = time.monotonic()
    engine.release(ctx.marginals[0], _generator(ctx.device, ctx.seeds()))
    ctx.setup["warm_release_s"] = time.monotonic() - t
    return engine


def run(ctx, engine) -> None:
    margs = ctx.marginals[0]
    end = time.monotonic() + ctx.seconds
    while time.monotonic() < end:
        seed = ctx.seeds()
        t0 = time.monotonic()
        try:
            tables, meas = engine.release(margs, _generator(ctx.device, seed))
        except Exception as exc:   # a failed release is counted, not fatal
            ctx.done(Done(0, seed, t0, time.monotonic(), repr(exc)), None, None)
            continue
        ctx.done(Done(0, seed, t0, time.monotonic()), tables, meas)


def close(engine) -> None:
    """Nothing to stop: the engine holds no thread or file."""
