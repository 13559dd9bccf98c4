"""Cross-request signature-batched measurement (the serving tier's fuse point).

The port of ``repro.engine.multi``.  ``measure`` (core/mechanism.py) batches
the cliques of ONE plan by per-axis signature; this module generalizes the
same trick across *requests*: the ``[v; z]`` rows of every (request, clique)
whose signature matches — even when the requests come from different
tenants with different plans and different budgets — stack into the batch
axis of a single chain call.  Eight tenants asking for the same ≤3-way
workload shape cost the same number of chain calls as one tenant.

Bit-exactness contract: ``measure(plan, margs, gen)`` draws ONE
``torch.randn`` over every cell of the plan's closure, in ``plan.cliques``
order (:func:`~repro_torch.core.mechanism.draw_noise`), and reads each
clique's rows at :func:`~repro_torch.core.mechanism.noise_offsets`.
:func:`measure_multi` draws each item's whole vector the same way, from the
item's own generator, and reads the same rows.  Every row of a chain is
computed independently of the other rows: both CUDA kernels sum each output
with one ``fmaf`` per term in k order, whatever the batch, the block's rows
or the route, and the plain versions sum term by term in k order.  So
``measure_multi(items)`` returns, for every item, exactly the bits that
``measure(plan, margs, gen)`` returns.  The JAX package's version keeps
threefry's per-clique key split instead; torch generators do not split, so
the two packages' noise differs by design.

Only plain-marginal plans qualify (their chain is determined by the
attribute-size signature alone); RP+/composite/secure plans are served
per-request through their cached engines by the caller.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.domain import Clique
from repro_torch.core.kron import kron_matvec_batched
from repro_torch.core.mechanism import (Measurement, draw_noise, noise_dtype,
                                        noise_offsets)
from repro_torch.core.residual import sub_matrix
from repro_torch.core.select import Plan
from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.kernels.kron_matvec.fused import fused_chain_matvec
from repro_torch.obs import TRACER

MultiItem = Tuple[Plan, Mapping[Clique, np.ndarray], torch.Generator]

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
_MIN_LANES = 8


def can_fuse(plan) -> bool:
    """True iff this plan's measurement chains are cross-request fusable.

    Plain :class:`~repro_torch.core.select.Plan` chains are fully determined
    by the attribute-size signature, so two requests with equal signatures
    share one chain.  RP+ plans carry per-attribute (Sub, Γ) factors and
    composite plans fan out to block engines — both are served per-request.
    """
    return type(plan) is Plan


def lane_bucket(g: int) -> int:
    """Lanes a group of ``g`` stacked cliques is padded to: the next power
    of two, at least 8.

    The chain shapes then repeat across drains of different sizes, which
    bounds the tuner's registry and its on-disk cache (their key holds the
    exact batch).  Pad lanes are zero rows of ``v`` and ``z``; their
    outputs are sliced away.
    """
    g_pad = _MIN_LANES
    while g_pad < g:
        g_pad *= 2
    return g_pad


def measure_multi(items: Sequence[MultiItem], use_kernel: Optional[bool] = None,
                  dtype=None, device=None) -> List[Dict[Clique, Measurement]]:
    """Algorithm 1 for many requests at once: one chain call per signature.

    ``items[i] = (plan, marginals, gen)`` exactly as the per-request
    ``measure(plan, marginals, gen, device=device)`` would receive them,
    ``gen`` a ``torch.Generator`` on ``device`` (CUDA unless
    ``device="cpu"``); the return value is the list of per-request
    measurement dicts, bit-identical to the per-request path.  Requests are
    grouped by attribute-size signature ACROSS items, so the number of chain
    calls is the number of distinct signatures in the union — not the sum
    of per-request signature counts.  ``use_kernel`` (default True) runs the
    chains on the fused kernel and its per-axis fallback (their plain
    versions on the CPU); False runs ``kron_matvec_batched``.
    """
    dev = resolve_device(device)
    use_kernel = True if use_kernel is None else bool(use_kernel)
    dtype = noise_dtype() if dtype is None else dtype
    if dtype not in _NP_DTYPES:
        raise TypeError(f"noise dtype {dtype}: expected float32 or float64")
    for plan, _m, _g in items:
        if not can_fuse(plan):
            raise ValueError(
                f"measure_multi serves plain marginal plans only, got "
                f"{type(plan).__name__}; route this request through "
                f"plan.engine().measure")

    # (signature dims) -> [(item index, clique, start of its noise rows)],
    # in item order and, within an item, in plan.cliques order.
    groups: Dict[tuple, List[tuple]] = defaultdict(list)
    noise = []
    for i, (plan, _margs, gen) in enumerate(items):
        noise.append(draw_noise(plan, gen, dev, dtype))
        offs = noise_offsets(plan)
        sizes = plan.domain.sizes
        for c in plan.cliques:
            groups[tuple(sizes[a] for a in c)].append((i, c, offs[c]))

    out: List[Dict[Clique, Measurement]] = [dict() for _ in items]
    for dims, members in groups.items():
        with TRACER.span("measure.multi.group").set(
                dims="x".join(map(str, dims)) if dims else "scalar",
                lanes=len(members)):
            om = _measure_group(items, noise, dims, members, use_kernel,
                                dtype, dev)
        for j, (i, c, _o) in enumerate(members):
            out[i][c] = Measurement(c, om[j], items[i][0].sigmas[c])
    return out


def _measure_group(items, noise, dims, members, use_kernel, dtype, dev
                   ) -> np.ndarray:
    """One signature group: assemble lanes, one chain call, slice back.

    Returns the (g, m) noisy answers on the host in member order.  The
    marginals are stacked on the host and copied once; the noise rows are
    views of each item's vector, gathered by one ``torch.cat``.
    """
    m = math.prod(dims)
    g = len(members)
    g_pad = lane_bucket(g) if dims else g
    v = np.zeros((g_pad, m), dtype=_NP_DTYPES[dtype])
    for j, (i, c, _o) in enumerate(members):
        row = np.asarray(items[i][1][c]).reshape(-1)
        if row.shape[0] != m:
            raise ValueError(f"marginal for {c} (request {i}) has "
                             f"{row.shape[0]} cells, want {m}")
        v[j] = row
    sig = torch.tensor([math.sqrt(items[i][0].sigmas[c])
                        for i, c, _o in members], dtype=dtype,
                       device=dev)[:, None]
    x = torch.empty((2 * g_pad, m), dtype=dtype, device=dev)
    x[:g_pad].copy_(torch.from_numpy(v))
    torch.cat([noise[i][o:o + m].view(1, m) for i, _c, o in members],
              out=x[g_pad:g_pad + g])
    x[g_pad + g:].zero_()
    if not dims:
        om = x[:g] + sig * x[g_pad:g_pad + g]
    else:
        factors = [sub_matrix(n) for n in dims]
        if use_kernel:
            y = fused_chain_matvec(factors, x, dims)
        else:
            y = kron_matvec_batched(factors, x, dims)
        om = y[:g] + sig * y[g_pad:g_pad + g]
    return om.cpu().numpy()
