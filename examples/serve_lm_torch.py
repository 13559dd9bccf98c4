"""Batched LM serving on the PyTorch port: prefill, then greedy decode from
KV/state caches.

The port's counterpart of ``examples/serve_lm.py``: weights drawn from a
seeded generator (nothing is downloaded), prompts from
``repro_torch.data.tokens.synthetic_lm_batches``, one prefill of the whole
batch padded to room for ``--gen`` tokens, then one ``decode_step`` per
token.  Runs on CUDA unless ``--device cpu``; ``--reduced`` takes the
architecture's small test config in place of its published widths.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen3-4b
      PYTHONPATH=src python examples/serve_lm_torch.py --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, load_all
from repro_torch.configs.shapes import reduced_config
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.models import Model, get_config


def make_batch(model: Model, batch: int, prompt_len: int, seed: int = 0):
    """Prompts from the synthetic token stream: tokens, or for a frontend
    stub their decode-path embeddings; an encoder-decoder's frames drawn
    from a generator seeded ``seed``."""
    cfg = model.cfg
    toks = next(synthetic_lm_batches(cfg.vocab_size, batch, prompt_len,
                                     seed=seed))["tokens"]
    tokens = torch.as_tensor(toks, device=model.device)
    out = {"tokens": tokens} if cfg.frontend == "none" else \
        {"embeds": model.token_embeds(tokens).float()}
    if cfg.encoder_layers:
        gen = torch.Generator(model.device).manual_seed(seed)
        out["enc_embeds"] = torch.randn(
            (batch, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=model.device)
    return out


def serve_batch(model: Model, batch, gen_tokens: int):
    """Greedy-decode ``gen_tokens`` tokens for every prompt of ``batch``.
    Returns the tokens (B, gen_tokens) on the host and the seconds of the
    prefill (to the first token) and of the decode steps."""
    prompt = batch.get("tokens", batch.get("embeds"))
    B, S = prompt.shape[0], prompt.shape[1]
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, caches = model.prefill(batch, cache_len=S + gen_tokens - 1)
    tok = logits[:, -1].argmax(-1)[:, None]
    out = [tok]
    sync()
    t1 = time.perf_counter()
    for i in range(gen_tokens - 1):
        logits, caches = model.decode_step(tok, caches, S + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(tok)
    sync()
    t2 = time.perf_counter()
    return torch.cat(out, dim=1).cpu(), {
        "prefill_s": t1 - t0, "decode_s": t2 - t1,
        "decode_tok_per_s": B * (gen_tokens - 1) / max(t2 - t1, 1e-9)}


def main(argv=None):
    load_all()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: cuda (raises without a card)")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's small test config")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    t0 = time.perf_counter()
    model = Model.init(cfg, device=args.device)
    init_s = time.perf_counter() - t0
    batch = make_batch(model, args.batch, args.prompt_len, args.seed)
    toks, stats = serve_batch(model, batch, args.gen)
    print(f"[serve] {cfg.name} on {model.device}: generated {tuple(toks.shape)} "
          f"tokens; init {init_s:.3f} s, prefill {stats['prefill_s']:.3f} s, "
          f"decode {stats['decode_tok_per_s']:.1f} tokens/s")
    print(f"[serve] first request: {toks[0].tolist()}")
    return toks, stats


if __name__ == "__main__":
    main()
