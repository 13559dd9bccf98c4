"""Qwen1.5-32B [hf:Qwen/Qwen1.5]: dense MHA (kv=40) with QKV bias."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
    vocab_size=152_064, head_dim=128, qkv_bias=True, param_dtype="bfloat16"))
