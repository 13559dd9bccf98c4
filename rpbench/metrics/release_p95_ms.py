"""release_p95_ms: the 95th percentile (nearest rank) of the latency of
every request completed in the window, by the harness's clock."""
from rpbench.harness.readers import nearest_rank


def read(obs):
    p = nearest_rank([b - a for a, b in obs.releases], 0.95)
    return None if p is None else p * 1e3
