"""unpack_ms.release: the program's measure.scatter and reconstruct.slice
spans (each group's result split into per-clique objects) in the traced
half, summed and divided by the requests completed
(``rpbench/harness/phases.py``)."""
from rpbench.harness.phases import phase_ms_per_request


def read(obs):
    return phase_ms_per_request(obs, ("measure.scatter", "reconstruct.slice"))
