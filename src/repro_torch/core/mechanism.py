"""Measurement phase: run the base mechanisms  M_A(x; σ²_A) = R_A x + N(0, σ²_A Σ_A).

Algorithm 1 of the paper: the residual answer is computed from the *marginal
table* on A (never from the full data vector):

    v  = Q_A x                      (marginal on A, shape Π_{i∈A} n_i)
    H  = ⊗_{i∈A} Sub_{n_i}          (implicit Kronecker factors)
    ω  = H v + σ_A · H z,   z ~ N(0, I)

so the noise H z has exactly the covariance σ²_A Σ_A = σ²_A H Hᵀ.

Noise is ONE ``torch.randn`` of Σ_A |cells(A)| values on the device, from the
caller's ``torch.Generator``, laid out in ``plan.cliques`` order
(:func:`draw_noise`).  Every path reads its cliques' slices of that vector,
so the signature-batched path and the per-clique loop draw identical noise.
Host traffic is one host-to-device copy of each signature group's stacked
marginals and one device-to-host copy of its answers; there is no
per-clique device op on the batched path.

``measure_np`` / ``measure_np_batched`` are the float64 host oracles.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.kernels.kron_matvec._layout import resolve_device

from .domain import Clique, Domain
from .kron import kron_matvec, kron_matvec_batched, kron_matvec_np
from .residual import p_coeff, sub_matrix
from .select import Plan


@dataclass
class Measurement:
    clique: Clique
    omega: np.ndarray          # noisy residual answer, shape Π_{i∈A}(n_i - 1)
    sigma2: float


def pcost_of_plan(plan: Plan) -> float:
    """Total privacy cost Σ_A p_A / σ²_A (Thm 3)."""
    return sum(p_coeff(plan.domain, c) / s for c, s in plan.sigmas.items())


def _clique_dims(domain: Domain, clique: Clique) -> List[int]:
    return [domain.attributes[i].size for i in clique]


def residual_answer(domain: Domain, clique: Clique, marginal: torch.Tensor,
                    use_kernel: bool = True) -> torch.Tensor:
    """H v — the exact residual query answer from the marginal table on ``clique``.

    ``use_kernel`` runs the per-axis kernel (its plain version on CPU
    tensors); ``False`` the plain batched torch path.
    """
    dims = _clique_dims(domain, clique)
    if not clique:
        return marginal.reshape(-1)
    factors = [sub_matrix(n) for n in dims]
    if use_kernel:
        from repro_torch.kernels.kron_matvec.ops import kron_matvec_kernel
        return kron_matvec_kernel(factors, marginal, dims)
    return kron_matvec(factors, marginal, dims)


def signature_groups(domain: Domain, cliques: Sequence[Clique],
                     axis_key=None) -> Dict[tuple, List[Clique]]:
    """Group cliques by per-axis signature (default: the attribute sizes).

    Cliques with equal signatures share the exact Kronecker chain
    ``⊗_i Sub_{n_i}`` and stack into the batch axis of one kernel chain.
    Insertion order preserves the input clique order within each group.
    """
    if axis_key is None:
        sizes = domain.sizes
        axis_key = sizes.__getitem__
    groups: Dict[tuple, List[Clique]] = defaultdict(list)
    for clique in cliques:
        groups[tuple(axis_key(i) for i in clique)].append(clique)
    return dict(groups)


def noise_dtype() -> torch.dtype:
    """Default dtype of the Gaussian noise draws: float32."""
    return torch.float32


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def noise_offsets(plan: Plan) -> Dict[Clique, int]:
    """Start of each clique's slice in the flat noise vector (plan order)."""
    dom = plan.domain
    offs, pos = {}, 0
    for c in plan.cliques:
        offs[c] = pos
        pos += dom.n_cells(c)
    return offs


def draw_noise(plan: Plan, gen: torch.Generator, device=None,
               dtype=None) -> torch.Tensor:
    """The flat N(0, I) vector of every base mechanism, in ``plan.cliques``
    order: ONE ``torch.randn`` from ``gen`` (which must live on ``device``)."""
    dev = resolve_device(device)
    total = sum(plan.domain.n_cells(c) for c in plan.cliques)
    return torch.randn(total, generator=gen, device=dev,
                       dtype=noise_dtype() if dtype is None else dtype)


def _group_noise(z: torch.Tensor, offs: Sequence[int], m: int) -> torch.Tensor:
    """(g, m) rows of the flat noise vector starting at ``offs``."""
    o0 = offs[0]
    if all(o == o0 + i * m for i, o in enumerate(offs)):
        return z[o0:o0 + len(offs) * m].view(len(offs), m)   # contiguous run
    idx = torch.as_tensor(offs, device=z.device)[:, None] \
        + torch.arange(m, device=z.device)
    return z[idx]


def _stack_marginals(marginals, cliques, m: int, dtype) -> np.ndarray:
    buf = np.empty((len(cliques), m), dtype=dtype)
    for i, c in enumerate(cliques):
        v = np.asarray(marginals[c]).reshape(-1)
        if v.shape[0] != m:
            raise ValueError(f"marginal for {c} has {v.shape[0]} cells, want {m}")
        buf[i] = v
    return buf


def measure(plan: Plan, marginals: Mapping[Clique, np.ndarray],
            gen: torch.Generator, use_kernel: bool = True,
            batched: bool = True, dtype=None,
            device=None) -> Dict[Clique, Measurement]:
    """Run every base mechanism in the plan (Algorithm 1, continuous Gaussian).

    ``marginals[A]`` must hold the exact marginal table for every A in the
    plan's closure (flattened or tensor shaped, host arrays).  ``gen`` is a
    ``torch.Generator`` on ``device``; the noise is :func:`draw_noise`.

    ``batched=True`` groups cliques by attribute-size signature and stacks
    all ``[v; z]`` pairs of a group into the batch axis of ONE chain per group
    (the fused kernel when ``use_kernel``, the plain batched torch path
    otherwise).  ``batched=False`` runs the per-clique loop (oracle /
    benchmark baseline), which reads the same noise.  ``dtype`` is the noise
    and arithmetic dtype: float32 (default) or float64; the kernels take
    float32 only.
    """
    dev = resolve_device(device)
    dtype = noise_dtype() if dtype is None else dtype
    if dtype not in _NP_DTYPES:
        raise TypeError(f"noise dtype {dtype}: expected float32 or float64")
    z_all = draw_noise(plan, gen, dev, dtype)
    offs = noise_offsets(plan)
    if not batched:
        return _measure_loop(plan, marginals, z_all, offs, use_kernel, dtype)
    np_dtype = _NP_DTYPES[dtype]
    out: Dict[Clique, Measurement] = {}
    for dims, cliques in signature_groups(plan.domain, plan.cliques).items():
        m = math.prod(dims)
        g = len(cliques)
        v = torch.from_numpy(_stack_marginals(marginals, cliques, m, np_dtype)
                             ).to(dev)
        z = _group_noise(z_all, [offs[c] for c in cliques], m)
        sig = torch.tensor([math.sqrt(plan.sigmas[c]) for c in cliques],
                           dtype=dtype, device=dev)[:, None]
        if not dims:
            om = v + sig * z
        else:
            x = torch.cat([v, z], dim=0)                  # (2g, m)
            factors = [sub_matrix(n) for n in dims]
            if use_kernel:
                from repro_torch.kernels.kron_matvec.fused import \
                    fused_chain_matvec
                y = fused_chain_matvec(factors, x, dims)
            else:
                y = kron_matvec_batched(factors, x, dims)
            om = y[:g] + sig * y[g:]
        om = om.cpu().numpy()
        for i, c in enumerate(cliques):
            out[c] = Measurement(c, om[i], plan.sigmas[c])
    return out


def _measure_loop(plan: Plan, marginals: Mapping[Clique, np.ndarray],
                  z_all: torch.Tensor, offs: Mapping[Clique, int],
                  use_kernel: bool, dtype) -> Dict[Clique, Measurement]:
    """Per-clique loop — one chain per clique (oracle / bench baseline)."""
    out: Dict[Clique, Measurement] = {}
    dev = z_all.device
    for clique in plan.cliques:
        m = plan.domain.n_cells(clique)
        v = torch.as_tensor(np.asarray(marginals[clique]).reshape(-1),
                            dtype=dtype, device=dev)
        if v.shape[0] != m:
            raise ValueError(f"marginal for {clique} has {v.shape[0]} cells, want {m}")
        z = z_all[offs[clique]:offs[clique] + m]
        sig = torch.tensor(math.sqrt(plan.sigmas[clique]), dtype=dtype,
                           device=dev)
        hv = residual_answer(plan.domain, clique, v, use_kernel)
        hz = residual_answer(plan.domain, clique, z, use_kernel)
        out[clique] = Measurement(clique, (hv + sig * hz).cpu().numpy(),
                                  plan.sigmas[clique])
    return out


def measure_np(plan: Plan, marginals: Mapping[Clique, np.ndarray],
               rng: np.random.Generator) -> Dict[Clique, Measurement]:
    """Host float64 oracle of `measure` (tests, tiny problems)."""
    out: Dict[Clique, Measurement] = {}
    for clique in plan.cliques:
        dims = _clique_dims(plan.domain, clique)
        v = np.asarray(marginals[clique], dtype=np.float64).reshape(-1)
        if not clique:
            out[clique] = Measurement(clique, v + math.sqrt(plan.sigmas[clique])
                                      * rng.standard_normal(1), plan.sigmas[clique])
            continue
        factors = [sub_matrix(n) for n in dims]
        z = rng.standard_normal(int(np.prod(dims)))
        hv = kron_matvec_np(factors, v, dims)
        hz = kron_matvec_np(factors, z, dims)
        out[clique] = Measurement(clique, hv + math.sqrt(plan.sigmas[clique]) * hz,
                                  plan.sigmas[clique])
    return out


def measure_np_batched(plan: Plan, marginals: Mapping[Clique, np.ndarray],
                       rng: np.random.Generator, chunk: int = 64
                       ) -> Dict[Clique, Measurement]:
    """Batched host float64 oracle: same-signature base mechanisms share
    stacked kron-matvecs, processed in cache-resident chunks."""
    out: Dict[Clique, Measurement] = {}
    for dims, cliques in signature_groups(plan.domain, plan.cliques).items():
        m = int(np.prod(dims)) if dims else 1
        for s0 in range(0, len(cliques), chunk):
            cs = cliques[s0:s0 + chunk]
            g = len(cs)
            v = np.stack([np.asarray(marginals[c], dtype=np.float64).reshape(-1)
                          for c in cs])
            z = rng.standard_normal((g, m))
            if dims:
                x = np.concatenate([v, z], axis=0).reshape((2 * g,) + dims)
                for axis, n in enumerate(dims):
                    s = sub_matrix(n)
                    x = np.moveaxis(
                        np.tensordot(s, np.moveaxis(x, axis + 1, 0),
                                     axes=([1], [0])), 0, axis + 1)
                x = x.reshape(2 * g, -1)
                hv, hz = x[:g], x[g:]
            else:
                hv, hz = v, z
            sig = np.array([math.sqrt(plan.sigmas[c]) for c in cs])[:, None]
            om = hv + sig * hz
            for i, c in enumerate(cs):
                out[c] = Measurement(c, om[i], plan.sigmas[c])
    return out


def exact_marginals_from_x(domain: Domain, cliques: Sequence[Clique],
                           x: np.ndarray) -> Dict[Clique, np.ndarray]:
    """Marginal tables Q_A x from a full contingency vector (small domains/tests)."""
    x = np.asarray(x, dtype=np.float64).reshape(domain.sizes)
    out = {}
    for c in cliques:
        keep = set(c)
        axes = tuple(i for i in range(domain.n_attrs) if i not in keep)
        out[c] = x.sum(axis=axes).reshape(-1)
    return out
