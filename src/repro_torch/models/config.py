"""Model configuration for the LM plane's architectures: the port of
``repro.models.config``.

Every architecture is a ``ModelConfig``; layer mixing is described by a
repeating ``pattern`` of block kinds (+ optional tail), which one loop over
pattern groups covers for the dense, MoE, SSM and hybrid families.  Dtypes
are names (``"float32"``, ``"bfloat16"``); :func:`torch_dtype` maps them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch

# block kinds: attn | attn_local | mla | mlstm | slstm | rglru
# ffn kinds:   swiglu | moe | none


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    pattern: Tuple[str, ...] = ("attn",)
    tail_pattern: Tuple[str, ...] = ()
    n_tail: int = 0                  # number of repeats of tail_pattern
    ffn: str = "swiglu"              # swiglu | moe | none
    moe: Optional[MoEConfig] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    local_window: int = 0            # for attn_local blocks
    # MLA (deepseek-style compressed KV)
    kv_lora_rank: int = 0
    # recurrent dims
    rnn_state_dim: int = 0           # rglru width (defaults to d_model)
    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0             # fixed encoder length (whisper frames)
    frontend: str = "none"           # none | embed_stub (precomputed embeddings)
    norm_eps: float = 1e-6
    param_dtype: str = "float32"     # float32 | bfloat16
    compute_dtype: str = "bfloat16"
    sub_quadratic: bool = False      # supports long_500k decode
    notes: str = ""

    @property
    def n_pattern_groups(self) -> int:
        main = self.n_layers - self.n_tail * len(self.tail_pattern)
        assert main % len(self.pattern) == 0, (
            f"{self.name}: {main} main layers not divisible by pattern "
            f"{self.pattern}")
        return main // len(self.pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def block_kinds(self) -> Tuple[str, ...]:
        """The full per-layer block-kind sequence."""
        return self.pattern * self.n_pattern_groups + self.tail_pattern * self.n_tail

    def n_params_estimate(self) -> int:
        """Rough parameter count (embeddings + blocks), for roofline MODEL_FLOPS."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.frontend == "none" else 2)
        total = emb + d  # final norm
        for kind in self.block_kinds():
            total += 2 * d  # norms
            if kind in ("attn", "attn_local"):
                total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    total += self.q_dim + 2 * self.kv_dim
            elif kind == "mla":
                r = self.kv_lora_rank
                total += d * self.q_dim + d * r + r * self.kv_dim * 2 + self.q_dim * d
            elif kind == "rglru":
                w = self.rnn_state_dim or d
                total += 2 * d * w + 3 * w + w * d  # in-proj(x2 gates), lambda/gates, out
            elif kind == "mlstm":
                total += 4 * d * self.q_dim + self.q_dim * d
            elif kind == "slstm":
                h = self.n_heads * self.head_dim
                total += 4 * d * h + 4 * h * self.head_dim + h * d
            if self.ffn == "swiglu" and self.d_ff:
                total += 3 * d * self.d_ff
            elif self.ffn == "moe" and self.moe:
                total += d * self.moe.n_experts
                total += self.moe.n_experts * 3 * d * self.moe.d_expert
                total += self.moe.n_shared * 3 * d * self.moe.d_expert
        # encoder
        if self.encoder_layers:
            per = 4 * d * self.q_dim + 3 * d * self.d_ff + 2 * d
            total += self.encoder_layers * per
            total += self.n_layers * (2 * d * self.kv_dim + d * self.q_dim + self.q_dim * d + d)  # cross attn
        return total

    def active_params_estimate(self) -> int:
        """Active (per-token) parameters — differs from total only for MoE."""
        if self.ffn != "moe" or self.moe is None:
            return self.n_params_estimate()
        d = self.d_model
        dense_like = replace(self, ffn="none", moe=None).n_params_estimate()
        per_layer = (d * self.moe.n_experts
                     + (self.moe.top_k + self.moe.n_shared) * 3 * d * self.moe.d_expert)
        return dense_like + len(self.block_kinds()) * per_layer


_REGISTRY: Dict[str, "ModelConfig"] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # configs register themselves on import
        import importlib
        importlib.import_module(
            "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``param_dtype``,
    ``compute_dtype``): bfloat16 for ``"bfloat16"``, else float32, as the
    reference maps them."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32
