"""Launch-config autotuner of the fused Kronecker-chain kernel.

Environment: ``REPRO_KERNEL_AUTOTUNE`` (``off`` | ``model``, the default |
``measure``), ``REPRO_KERNEL_COMPUTE_DTYPES`` (operand types to score, e.g.
``float32,bfloat16``; default float32 alone) and ``REPRO_AUTOTUNE_CACHE``
(the cache directory; default ``~/.cache/repro_torch/autotune``).
"""
from .cache import CACHE_VERSION, TuningCache, default_cache_dir
from .tuner import (TunedConfig, autotune_mode, chain_key, pretune,
                    registry_snapshot, reset_registry, resolve_config,
                    tune_chain)

__all__ = ["CACHE_VERSION", "TuningCache", "default_cache_dir",
           "TunedConfig", "autotune_mode", "chain_key", "pretune",
           "registry_snapshot", "reset_registry", "resolve_config",
           "tune_chain"]
