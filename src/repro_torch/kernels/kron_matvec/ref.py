"""Plain PyTorch oracles for the kron_matvec kernels."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.kron import kron_matvec


def kron_matvec_ref(factors: Sequence, x: torch.Tensor,
                    dims: Sequence[int]) -> torch.Tensor:
    """(⊗_i factors[i]) x — reshape + tensordot reference implementation."""
    return kron_matvec(factors, x, dims)


def residual_measure_ref(factors: Sequence, v: torch.Tensor, z: torch.Tensor,
                         sigma: float, dims: Sequence[int]) -> torch.Tensor:
    """H v + σ H z  (Alg 1 measurement) via two reference matvecs."""
    return kron_matvec(factors, v, dims) + sigma * kron_matvec(factors, z, dims)
