from .engine import ChainRegistry, EngineStats, MarginalEngine, ReleaseServing
from .plus_engine import PlusEngine
from .discrete_engine import DiscreteEngine
from .composite import CompositeEngine
from .sharded import sharded_marginals, sharded_measure
from .corpus_stats import corpus_marginal_release
from .multi import can_fuse, measure_multi
