"""stage_ms.release: the program's measure.stack and reconstruct.embed
spans (each signature group's host array and its chain's factors) in the
traced half, summed and divided by the requests completed
(``rpbench/harness/phases.py``)."""
from rpbench.harness.phases import phase_ms_per_request


def read(obs):
    return phase_ms_per_request(obs, ("measure.stack", "reconstruct.embed"))
