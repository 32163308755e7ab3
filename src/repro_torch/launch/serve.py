"""Serving CLI: ``python -m repro_torch.launch.serve --arch smollm-360m -n 32``

Batched prefill and decode with the serve engine's ``generate`` on the CUDA
card (or, with ``--device cpu``, on the CPU), at full width unless
``--reduced`` is given.  Weights are random from seed 0; the prompts (K
codes a token for a codebook arch, and a vision arch's patch embeddings)
and any temperature sampling draw from a ``torch.Generator`` seeded with
``--seed``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config, list_archs
from repro_torch.device import resolve
from repro_torch.models import model
from repro_torch.serve import engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("-n", "--num-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=1,
                    help="seed of the prompts and of temperature sampling")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (default: full width)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = model.init_params(cfg, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    shape = (args.batch, args.prompt_len) + (
        (cfg.num_codebooks,) if cfg.num_codebooks else ())
    prompts = {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                       generator=gen, device=device)}
    if cfg.num_prefix_tokens:          # the vision stub's patch embeddings
        prompts["prefix_embed"] = torch.randn(
            args.batch, cfg.num_prefix_tokens, cfg.d_model, generator=gen,
            device=device)
    scfg = engine.ServeConfig(temperature=args.temperature,
                              max_seq=args.prompt_len + args.num_tokens + 8)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = engine.generate(params, cfg, prompts, args.num_tokens, scfg,
                          generator=gen)
    out_host = out.cpu()                   # waits for the card's work
    dt = time.perf_counter() - t0
    total = args.batch * args.num_tokens
    print(f"[serve] {args.arch}: {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s batched) on {device}")
    print(out_host[0][:16].tolist())
    return out_host


if __name__ == "__main__":
    main()
