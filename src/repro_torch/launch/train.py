"""Training CLI: ``python -m repro_torch.launch.train --arch smollm-360m``

Runs the Sentinel pipeline on the CUDA card (or, with ``--device cpu``, on
the CPU): dynamic profiling (one forward and backward traced on the meta
device), migration-interval planning on ``H100_COST``, then the
fault-tolerant training loop with the planned offload config.  The config
is full width unless ``--reduced`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import runtime
from repro_torch.configs.base import get_config, list_archs
from repro_torch.core import profiler
from repro_torch.core.offload import SentinelConfig, from_plan
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.train import loop


def profile_step(cfg, batch: int, seq: int) -> profiler.TraceProfile:
    """The data-object profile of one training step of ``cfg`` at
    ``batch`` x ``seq`` tokens, traced on the meta device, with the
    reference's batch shapes: tokens and labels (B, S, K) for K codebooks,
    labels (B, P + S) and a float32 ``prefix_embed`` (B, P, d) for a
    prefix of P patch embeddings."""
    params = model.init_params(cfg, device="meta", requires_grad=True)
    K, P = cfg.num_codebooks, cfg.num_prefix_tokens

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    b = {"tokens": meta(batch, seq, K) if K else meta(batch, seq),
         "labels": meta(batch, seq, K) if K else meta(batch, seq + P)}
    if P:
        b["prefix_embed"] = meta(batch, P, cfg.d_model, dtype=torch.float32)
    return profiler.trace_profile(
        lambda p, bb: model.loss_fn(p, cfg, bb, unroll_periods=True),
        params, b, num_periods=cfg.num_periods)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (default: full width)")
    ap.add_argument("--mi", type=int, default=0,
                    help="migration interval override (0 = plan it)")
    ap.add_argument("--mode", default="offload",
                    choices=["offload", "save_hbm", "remat", "full"])
    ap.add_argument("--offload-opt-state", action="store_true",
                    help="AdamW moments in pinned host memory")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--fast-frac", type=float, default=0.3)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    # ---- Sentinel pipeline: profile -> plan -> configure ----
    if args.mi:
        scfg = SentinelConfig(mode=args.mode, mi_periods=args.mi,
                              offload_opt_state=args.offload_opt_state)
        print(f"[train] MI override: {args.mi} periods")
    else:
        prof = profile_step(cfg, args.batch, args.seq)
        plan = runtime.plan(prof, runtime.H100_COST,
                            args.fast_frac * prof.peak_bytes())
        scfg = dataclasses.replace(
            from_plan(prof, plan, offload_opt_state=args.offload_opt_state),
            mode=args.mode)
        print(f"[train] profiled {len(prof.objects)} data objects; "
              f"planned MI={plan.mi} steps -> {scfg.mi_periods} periods "
              f"(case3 policy: {'stall' if plan.stall_on_case3 else 'slow'})")

    ocfg = adamw.OptConfig(total_steps=args.steps,
                           warmup_steps=max(1, args.steps // 10))
    dcfg = DataConfig(seed=0, vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch,
                      num_codebooks=cfg.num_codebooks,
                      num_prefix_tokens=cfg.num_prefix_tokens,
                      d_model=cfg.d_model)
    tcfg = loop.TrainConfig(steps=args.steps,
                            ckpt_every=max(10, args.steps // 5),
                            ckpt_dir=args.ckpt_dir, log_every=10)
    out = loop.run(cfg, tcfg, scfg, ocfg, dcfg, device=device)
    print(f"[train] done; final loss {out['losses'][-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
