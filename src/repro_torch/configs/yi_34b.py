"""Yi-34B [arXiv:2403.04652]: llama-arch GQA."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64_000, head_dim=128, rope_theta=5e6, param_dtype="bfloat16"))
