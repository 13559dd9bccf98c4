"""DeepSeek-V2 236B [arXiv:2405.04434]: MLA (kv_lora=512) + 160-expert top-6 MoE."""
from repro_torch.models.config import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=1536,
    vocab_size=102_400, head_dim=128,
    pattern=("mla",), kv_lora_rank=512,
    ffn="moe", moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2),
    param_dtype="bfloat16",
    notes="All layers MoE (paper-table simplification; real model has 1 dense layer)."))
