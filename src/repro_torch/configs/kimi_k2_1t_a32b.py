"""Kimi K2 (1T total / 32B active) [arXiv:2501.kimi2]: 384-expert top-8 MoE."""
from repro_torch.models.config import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163_840, head_dim=128,
    ffn="moe", moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared=1),
    param_dtype="bfloat16",
    notes="d_ff is the per-expert width; 1 shared expert (paper-table config)."))
