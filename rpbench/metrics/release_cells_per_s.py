"""release_cells_per_s: workload cells of every request completed in the
window, over the time from the window's start to the last completion."""


def read(obs):
    if not obs.releases:
        return None
    span = max(b for _, b in obs.releases) - obs.window[0]
    return len(obs.releases) * obs.cells / span
