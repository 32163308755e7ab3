"""The system under test: the PyTorch and CUDA port, ``src/repro_torch``.
The harness reaches it only through here and the cell drivers."""
from __future__ import annotations

import dataclasses

# the configuration file's keys (the published config.json's names) and the
# port's ModelConfig fields they set
FIELDS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
          "num_attention_heads": "num_heads",
          "num_key_value_heads": "num_kv_heads",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "head_dim": "head_dim", "rope_theta": "rope_theta",
          "rms_norm_eps": "norm_eps",
          "tie_word_embeddings": "tie_embeddings"}


def registered(cfg: dict):
    """The port's own registered config that the file names."""
    from repro_torch.configs.base import get_config
    return get_config(cfg["port_config"])


def config(cfg: dict, **extra):
    """The port's ModelConfig for the file as it is run: the registered
    config with every number of the file set, in bfloat16."""
    values = {f: cfg[k] for k, f in FIELDS.items()}
    return dataclasses.replace(registered(cfg), dtype="bfloat16",
                               **values, **extra)


def differences(cfg: dict) -> dict:
    """{file key: (file's value, the registered config's value)} where the
    port's registered config departs from the file."""
    reg = registered(cfg)
    return {k: (cfg[k], getattr(reg, f)) for k, f in FIELDS.items()
            if cfg[k] != getattr(reg, f)}


def model(cfg: dict, pc, w: dict, device, *, train: bool):
    """The port's model for ``pc`` on ``device`` holding the benchmark's
    weights ``w``."""
    import torch
    from repro_torch.models import model as port_model

    from benchkit import weights
    m = port_model.Model(pc, device=device, dtype=torch.bfloat16)
    weights.load_into(m, cfg, w)
    return m.requires_grad_(train)
