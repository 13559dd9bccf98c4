"""Whisper-small [arXiv:2212.04356]: enc-dec; conv/audio frontend is a stub —
input_specs() provides precomputed frame embeddings (B, 1500, d)."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=51_865, head_dim=64, rope_theta=10_000.0,
    encoder_layers=12, encoder_seq=1500,
    notes="Decoder tokens embedded normally; encoder consumes stub frame embeds."))
