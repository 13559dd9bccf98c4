"""dispatch_ms.release: the program's kernel.chain spans (a chain call's
host work: planning, packing, the queued launch) in the traced half, summed
and divided by the requests completed (``rpbench/harness/phases.py``)."""
from rpbench.harness.phases import phase_ms_per_request


def read(obs):
    return phase_ms_per_request(obs, ("kernel.chain",))
