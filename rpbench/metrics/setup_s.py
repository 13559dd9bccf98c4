"""setup_s: seconds from the process's start to the first timed request
(torch import, CUDA context, kernel build or load, inputs, plan, engine with
its precompile, one warm release)."""


def read(obs):
    return obs.setup_s
