"""Assigned input shapes and per-(arch × shape) input specs.

The four LM shape cells (seq_len × global_batch):
    train_4k      4,096 × 256   (training)
    prefill_32k  32,768 × 32    (inference: prefill)
    decode_32k   32,768 × 128   (inference: ONE decode step w/ full cache)
    long_500k   524,288 × 1     (long-context decode; sub-quadratic archs only)

``input_specs`` returns ``(shape, torch.dtype)`` pairs, never allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig, get_config

Spec = Tuple[Tuple[int, ...], torch.dtype]

SHAPES: Dict[str, Dict] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}

# Microbatch counts for train_4k (grad accumulation), as the reference's.
TRAIN_MICROBATCHES: Dict[str, int] = {
    "xlstm-350m": 2,
    "recurrentgemma-2b": 4,
    "qwen2.5-14b": 8,
    "qwen1.5-32b": 8,
    "yi-34b": 8,
    "qwen3-4b": 4,
    "kimi-k2-1t-a32b": 16,
    "deepseek-v2-236b": 16,
    "chameleon-34b": 8,
    "whisper-small": 8,
}


def cell_is_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k dense KV decode is "
                       "architecturally quadratic (skip per docs/DESIGN.md)")
    return True, ""


def input_specs(arch: str, shape: str) -> Dict[str, Spec]:
    """``(shape, dtype)`` of every model input of the cell."""
    cfg = get_config(arch)
    sh = SHAPES[shape]
    B, S = sh["global_batch"], sh["seq_len"]
    i32 = torch.int32
    emb_dt = torch.bfloat16
    specs: Dict[str, Spec] = {}
    if sh["kind"] in ("train", "prefill"):
        if cfg.frontend == "embed_stub":
            specs["embeds"] = ((B, S, cfg.d_model), emb_dt)
        else:
            specs["tokens"] = ((B, S), i32)
        if sh["kind"] == "train":
            specs["labels"] = ((B, S), i32)
        if cfg.encoder_layers:
            specs["enc_embeds"] = ((B, cfg.encoder_seq, cfg.d_model), emb_dt)
    else:  # decode: one new token against a seq_len cache
        specs["tokens"] = ((B, 1), i32)
        specs["pos"] = ((), i32)
    return specs


def reduced_config(arch: str) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's widths)."""
    cfg = get_config(arch)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=len(cfg.pattern) + len(cfg.tail_pattern) * (1 if cfg.n_tail else 0),
        d_model=64, n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16, d_ff=128 if cfg.d_ff else 0,
        vocab_size=256, local_window=8 if cfg.local_window else 0,
        rnn_state_dim=64 if cfg.rnn_state_dim else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        n_tail=1 if cfg.n_tail else 0,
        encoder_layers=1 if cfg.encoder_layers else 0,
        encoder_seq=12 if cfg.encoder_seq else 0,
        param_dtype="float32", compute_dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=8, top_k=2,
                                        d_expert=32, n_shared=min(cfg.moe.n_shared, 1))
        kw["d_ff"] = 32
    return dataclasses.replace(cfg, **kw)
