"""Implicit Kronecker-product linear algebra.

A Kronecker matvec ``(V_1 ⊗ … ⊗ V_k) x`` is evaluated by reshaping ``x`` to
the tensor ``(n_1, …, n_k)`` and contracting each factor along its own axis —
never materializing ``⊗_i V_i``.

  * ``kron_matvec`` / ``kron_matvec_batched`` — torch, on the tensor's device
    (the plain batched path: ``torch.tensordot`` per axis, no hand-written
    kernel; the kernels live in :mod:`repro_torch.kernels.kron_matvec`);
  * ``kron_matvec_np`` / ``kron_expand`` — numpy float64 oracles, copied from
    the JAX package unchanged.

``None`` factors mean "identity on that axis" and are skipped.  A factor may
also be the string ``"ones"``: the all-ones row vector (marginalize the axis).
"""
from __future__ import annotations

from functools import reduce
from typing import Sequence, Union

import numpy as np
import torch

Factor = Union[None, str, np.ndarray, torch.Tensor]


def _apply_axis(x: torch.Tensor, mat, axis: int) -> torch.Tensor:
    mat = torch.as_tensor(mat, dtype=x.dtype, device=x.device)
    y = torch.tensordot(mat, torch.movedim(x, axis, 0), dims=([1], [0]))
    return torch.movedim(y, 0, axis)


def _chain(factors: Sequence[Factor], x: torch.Tensor, first: int) -> torch.Tensor:
    for axis, f in enumerate(factors, start=first):
        if f is None:
            continue
        if isinstance(f, str):
            if f == "ones":
                x = x.sum(dim=axis, keepdim=True)
                continue
            raise ValueError(f)
        x = _apply_axis(x, f, axis)
    return x


def kron_matvec(factors: Sequence[Factor], x: torch.Tensor,
                dims: Sequence[int]) -> torch.Tensor:
    """Apply ``⊗_i factors[i]`` to ``x`` (flattened ok); returns a flat tensor.

    dims: the per-axis input sizes n_i (needed to reshape a flat x).
    """
    x = torch.as_tensor(x).reshape(tuple(int(d) for d in dims))
    return _chain(factors, x, 0).reshape(-1)


def kron_matvec_batched(factors: Sequence[Factor], x: torch.Tensor,
                        dims: Sequence[int]) -> torch.Tensor:
    """Apply ``⊗_i factors[i]`` to every row of a stack ``x`` (B, Π dims).

    Returns shape (B, Π out_dims).
    """
    x = torch.as_tensor(x)
    b = x.shape[0]
    x = x.reshape((b,) + tuple(int(d) for d in dims))
    return _chain(factors, x, 1).reshape(b, -1)


def kron_matvec_np(factors: Sequence[Factor], x: np.ndarray,
                   dims: Sequence[int]) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64).reshape(tuple(dims))
    for axis, f in enumerate(factors):
        if f is None:
            continue
        if isinstance(f, str):
            if f == "ones":
                x = np.sum(x, axis=axis, keepdims=True)
                continue
            raise ValueError(f)
        f = np.asarray(f, dtype=np.float64)
        x = np.moveaxis(np.tensordot(f, np.moveaxis(x, axis, 0), axes=([1], [0])), 0, axis)
    return x.reshape(-1)


def kron_expand(factors: Sequence[np.ndarray]) -> np.ndarray:
    """Materialize a small Kronecker product (tests / tiny domains only)."""
    mats = [np.asarray(f, dtype=np.float64) for f in factors]
    return reduce(np.kron, mats) if mats else np.ones((1, 1))
