"""copy_ms.release: the program's measure.h2d, measure.d2h, reconstruct.h2d
and reconstruct.d2h spans (each group's copies to the card, and back, which
waits for its chain) in the traced half, summed and divided by the requests
completed (``rpbench/harness/phases.py``)."""
from rpbench.harness.phases import phase_ms_per_request


def read(obs):
    return phase_ms_per_request(obs, ("measure.h2d", "measure.d2h",
                                      "reconstruct.h2d", "reconstruct.d2h"))
