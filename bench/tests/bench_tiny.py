"""Tiny stand-ins for the cells' configuration and mixes, for CPU tests:
the published files with small numbers set."""
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
SMALL = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             vocab_size=500)


def config(name="smollm-360m", **kw):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(SMALL, **kw)
    return cfg


def train_mix(mode="offload"):
    mix = json.loads((BENCH / "traffic" / f"train.{mode}.json").read_text())
    mix.update(batch=2, seq=32)
    return mix


def serve_mix():
    mix = json.loads((BENCH / "traffic" / "serve.decode.json").read_text())
    mix.update(slots=4, page_tokens=16, prefill_chunk_tokens=32,
               layer_group=2, prompts={"lo": 64, "hi": 128, "n": 4, "page": 16},
               answer_tokens=48, max_seq=192, profile_decode_steps=16,
               sample={"sessions": 2})
    return mix
