"""RecurrentGemma-2B / Griffin [arXiv:2402.19427]: RG-LRU + local attention, 1:2."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256_000, head_dim=256,
    pattern=("rglru", "rglru", "attn_local"), tail_pattern=("rglru",), n_tail=2,
    local_window=2048, rnn_state_dim=2560, sub_quadratic=True,
    notes="(R,R,A)x8 + (R,R) = 26 blocks; MQA (kv=1), window 2048."))
