"""Layout helpers shared by the per-axis (ops.py) and fused (fused.py) paths.

One definition of factor normalization keeps the two kernel paths in exact
agreement about what a factor *means* — an identity matrix, ``None`` and a
skipped axis are the same thing on both, as in the JAX package.  The JAX
package's ``interpret_default`` (Pallas interpret mode off the TPU) becomes
:func:`resolve_device`: the port runs on CUDA unless the caller asks for the
CPU, and it never falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and there is no
    CUDA device; pass ``device="cpu"`` to run the plain PyTorch versions.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; repro_torch runs on "
                           "CUDA by default, pass device='cpu' to run on the CPU")
    return dev


def pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def normalize_factor(f, n: int) -> Optional[np.ndarray]:
    """None/identity → None (axis untouched); 'ones' → (1, n) row; else matrix."""
    if f is None:
        return None
    if isinstance(f, str):
        if f == "ones":
            return np.ones((1, n), dtype=np.float32)
        raise ValueError(f)
    f = np.asarray(f, dtype=np.float32)
    if f.shape == (n, n) and np.allclose(f, np.eye(n)):
        return None   # explicit identity: skip the contraction
    return f
