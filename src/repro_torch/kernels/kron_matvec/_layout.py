"""Layout helpers shared by the per-axis (ops.py) and fused (fused.py) paths.

One definition of factor normalization keeps the two kernel paths in exact
agreement about what a factor *means* — an identity matrix, ``None`` and a
skipped axis are the same thing on both, as in the JAX package.  The JAX
package's ``interpret_default`` (Pallas interpret mode off the TPU) becomes
:func:`resolve_device`: the port runs on CUDA unless the caller asks for the
CPU, and it never falls back to the CPU on its own.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
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
    if f.shape == (n, n) and _may_be_identity(f) and np.allclose(f, np.eye(n)):
        return None   # explicit identity: skip the contraction
    return f


def _may_be_identity(f: np.ndarray) -> bool:
    """False when f[0, 0] or f[0, 1] alone fails ``np.allclose`` against the
    identity (its default tolerances), so the full comparison, the costliest
    host step of a chain call, runs only for matrices that may pass it."""
    if not abs(float(f[0, 0]) - 1.0) <= 1e-8 + 1e-5:
        return False
    return f.shape[1] < 2 or abs(float(f[0, 1])) <= 1e-8


# Factors on the card, by content: (device, dtype, shape, bytes) -> tensor.
# A server's worker and a thread registering a tenant both reach the cache,
# so every read and write of it and of its byte count holds _FACTORS_LOCK.
_DEVICE_FACTORS: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()  # guarded-by: _FACTORS_LOCK
_DEVICE_FACTORS_MAX_BYTES = 64 << 20   # host bytes of the keys held at most
_device_factor_bytes = 0               # guarded-by: _FACTORS_LOCK
_FACTORS_LOCK = threading.Lock()


def device_factor(a: np.ndarray, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """``a`` as a ``dtype`` tensor on ``device``, copied once per content.

    A copy from pageable host memory to the card waits for the stream to
    drain, so a copy in every chain call leaves the card idle between
    back-to-back launches for the host's round trip.  A chain's factors
    repeat from call to call, so each distinct array is copied once and kept,
    least recently used first out, up to 64 MiB of keys.  The tensor is
    shared between calls: kernels read it and nothing writes it.
    """
    global _device_factor_bytes
    a = np.ascontiguousarray(a)
    key = (str(device), dtype, a.dtype.str, a.shape, a.tobytes())
    with _FACTORS_LOCK:
        t = _DEVICE_FACTORS.get(key)
        if t is not None:
            _DEVICE_FACTORS.move_to_end(key)
            return t
        t = torch.from_numpy(a.copy()).to(dtype).to(device)
        _DEVICE_FACTORS[key] = t
        _device_factor_bytes += a.nbytes
        while _device_factor_bytes > _DEVICE_FACTORS_MAX_BYTES \
                and len(_DEVICE_FACTORS) > 1:
            old, _ = _DEVICE_FACTORS.popitem(last=False)
            _device_factor_bytes -= len(old[-1])
        return t


def clear_device_factors() -> None:
    """Drop every kept factor (their device memory returns to the caching
    allocator)."""
    global _device_factor_bytes
    with _FACTORS_LOCK:
        _DEVICE_FACTORS.clear()
        _device_factor_bytes = 0
