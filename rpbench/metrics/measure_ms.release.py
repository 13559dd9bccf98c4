"""measure_ms.release: the program's engine.measure spans in the window,
summed and divided by the requests completed (host wall time, ending after
the copy that returns numpy)."""
from rpbench.harness.readers import span_ms_per_request


def read(obs):
    return span_ms_per_request(obs, "engine.measure")
