"""The LM plane's models in PyTorch: the port of ``repro.models``'s
serving path (configs, layers, recurrent mixers, MoE, the model)."""
from .config import ModelConfig, MoEConfig, get_config, list_configs, register
from .transformer import (Model, cache_axes, cache_defs, cache_len,
                          init_cache, model_defs, pad_caches, place_caches)

__all__ = [n for n in dir() if not n.startswith("_")]
