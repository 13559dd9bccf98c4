"""kernel_roofline_pct.release: the least time of every Kronecker chain
that the window's requests need (rpbench/harness/work.py: bytes over the
card's memory rate or float32 operations over its float32 rate, whichever
is larger, from the plan's shapes), over the device time of every kernel in
the traced window, in percent."""


def read(obs):
    if obs.trace is None or obs.least_s is None or not obs.releases:
        return None
    kernel_s = obs.trace.kernel_seconds()
    if kernel_s <= 0:
        return None
    return 100.0 * len(obs.releases) * obs.least_s / kernel_s
