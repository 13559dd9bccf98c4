"""Chameleon-34B [arXiv:2405.09818]: early-fusion VLM; VQ frontend is a stub —
input_specs() provides precomputed fused token embeddings."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=65_536, head_dim=128, qk_norm=True,
    frontend="embed_stub", param_dtype="bfloat16",
    notes="Backbone only; VQ image tokenizer stubbed per the brief."))
