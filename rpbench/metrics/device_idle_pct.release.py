"""device_idle_pct.release: the share of the traced window in which no
kernel and no copy ran on the device (the profiler's timeline), in
percent."""


def read(obs):
    if obs.trace is None or not obs.trace.ops:
        return None
    lo, hi = obs.window
    return 100.0 * (1.0 - obs.trace.busy(lo, hi) / (hi - lo))
