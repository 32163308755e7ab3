"""Synthetic token pipeline with host-side prefetch (port of
``repro/data/pipeline.py``).

Deterministic per (seed, step): recovery after a failure replays the exact
same batches, and ``_host_batch`` gives the reference's bytes for the same
config and step, codebook tokens (musicgen) and prefix embeddings
(paligemma's stub) included.  ``make_batch`` puts a batch on one device
(the reference's sharded placement waits for the port's mesh, ROADMAP item
11).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32_000
    seq_len: int = 1024
    global_batch: int = 8
    num_codebooks: int = 0
    num_prefix_tokens: int = 0
    d_model: int = 0              # for prefix embeddings (vlm stub)


def _host_batch(cfg: DataConfig, step: int) -> dict:
    """Full logical batch for `step` (numpy, deterministic), drawn in the
    reference's order: tokens (B, S) or (B, S, K), then the prefix
    embeddings (B, P, d) float32, whose labels are left-padded with P
    zeros (the loss skips the prefix rows)."""
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    shape = (cfg.global_batch, cfg.seq_len)
    if cfg.num_codebooks:
        shape = shape + (cfg.num_codebooks,)
    tokens = rng.integers(0, cfg.vocab_size, size=shape, dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)   # (B,S) or (B,S,K): next token
    out = {"tokens": tokens, "labels": labels.astype(np.int32)}
    if cfg.num_prefix_tokens:
        out["prefix_embed"] = rng.standard_normal(
            (cfg.global_batch, cfg.num_prefix_tokens, cfg.d_model),
            dtype=np.float32)
        out["labels"] = np.pad(out["labels"],
                               ((0, 0), (cfg.num_prefix_tokens, 0)))
    return out


def make_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """The batch of ``step`` as tensors on ``device`` (default: the CUDA
    card; raises without one unless ``device="cpu"``)."""
    dev = resolve(device)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in _host_batch(cfg, step).items()}


class Prefetcher:
    """Background-thread prefetch of the next `depth` batches."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2,
                 device=None):
        self.cfg = cfg
        self.device = resolve(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, make_batch(self.cfg, step, self.device)),
                           timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
