"""reconstruct_ms.release: the program's engine.reconstruct spans in the
window, summed and divided by the requests completed."""
from rpbench.harness.readers import span_ms_per_request


def read(obs):
    return span_ms_per_request(obs, "engine.reconstruct")
