"""Shared label construction so predicted and measured series line up.

The roofline gauges (emitted at chain registration) and the kernel launch
histogram (emitted at every launch) must carry the *same* ``chain`` label
value, or predicted-vs-measured drift stops being a single join.  Keep the
format here, in one place.
"""
from __future__ import annotations

from typing import Sequence


def chain_label(dims: Sequence[int], batch: int, compute_dtype=None) -> str:
    """Canonical chain identity: ``5x5x5/b16/f32``-style.

    ``dims`` are the per-axis sizes of the Kronecker chain, ``batch`` the
    (unpadded) lane count, ``compute_dtype`` the kernel compute dtype
    (None → f32, the default).
    """
    d = "x".join(str(int(n)) for n in dims) if dims else "scalar"
    dt = str(compute_dtype or "float32")
    dt = {"float32": "f32", "bfloat16": "bf16", "float64": "f64"}.get(dt, dt)
    return f"{d}/b{int(batch)}/{dt}"
