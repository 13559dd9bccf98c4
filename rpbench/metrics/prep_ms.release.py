"""prep_ms.release: the program's measure.prep and reconstruct.prep spans
(the noise draw, its offsets and each phase's grouping of cliques by
signature) in the traced half, summed and divided by the requests completed
(``rpbench/harness/phases.py``)."""
from rpbench.harness.phases import phase_ms_per_request


def read(obs):
    return phase_ms_per_request(obs, ("measure.prep", "reconstruct.prep"))
