from .engine import ChainRegistry, EngineStats, MarginalEngine, ReleaseServing
from .discrete_engine import DiscreteEngine
