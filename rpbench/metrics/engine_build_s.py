"""engine_build_s: the harness's clock around the engine's constructor
(chain registration and precompile; on a checkout's first run the kernels'
build too)."""


def read(obs):
    return obs.setup.get("engine_build_s")
