from .engine import ChainRegistry, EngineStats, MarginalEngine, ReleaseServing
