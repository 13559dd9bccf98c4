"""Qwen2.5-14B [hf:Qwen/Qwen2.5]: dense GQA with QKV bias."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab_size=152_064, head_dim=128, qkv_bias=True, rope_theta=1e6))
