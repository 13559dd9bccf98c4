"""xLSTM-350M [arXiv:2405.04517]: alternating mLSTM/sLSTM blocks, no separate FFN."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, head_dim=256,
    pattern=("mlstm", "slstm"), ffn="none",
    rope_theta=0.0, sub_quadratic=True,
    notes="d_ff=0: the xLSTM blocks carry their own projections (paper config)."))
