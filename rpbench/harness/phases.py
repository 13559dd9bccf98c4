"""The release's per-group phase spans, read from the program's tracer.

``Observation.spans`` holds only the spans that ``run.SPAN_NAMES`` names,
and the phase spans (``measure.stack``, ``reconstruct.h2d``, ...) are not
among them.  The program's tracer keeps every span name's count and
seconds since it was last enabled (``repro_torch.obs.TRACER.totals()``),
and a traced run enables it at the start of the traced half and disables
it at the end: so its totals are the phase spans of exactly the releases
that half completed.  A program without such totals, or without the
spans, reads as nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence


def phase_ms_per_request(obs, names: Sequence[str]) -> Optional[float]:
    """Milliseconds of the program's ``names`` spans in the traced half,
    summed and divided by the requests completed there; None where the
    program keeps no such span."""
    try:
        from repro_torch.obs import TRACER
        totals = TRACER.totals()
    except (ImportError, AttributeError):
        return None
    found = [totals[n][1] for n in names if n in totals]
    if not found or not obs.releases:
        return None
    return sum(found) / len(obs.releases) * 1e3
