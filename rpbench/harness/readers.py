"""Arithmetic the per-layer readers share."""
from __future__ import annotations

import math
from typing import Optional


def span_ms_per_request(obs, name: str) -> Optional[float]:
    """Milliseconds of the program's ``name`` spans that started in the
    window, summed and divided by the requests completed there; None where
    there is no such span."""
    lo, hi = obs.window
    durs = [b - a for n, a, b in obs.spans if n == name and lo <= a <= hi]
    if not durs or not obs.releases:
        return None
    return sum(durs) / len(obs.releases) * 1e3


def nearest_rank(values, q: float) -> Optional[float]:
    """The ``q`` quantile of ``values`` by nearest rank; None if empty."""
    vals = sorted(values)
    if not vals:
        return None
    return vals[max(0, math.ceil(q * len(vals)) - 1)]
