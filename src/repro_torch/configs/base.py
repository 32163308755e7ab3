"""Model configs and the arch registry (the port's own copy of
``repro/configs/base.py``, every field and every registered arch: ATTN/LOCAL
stacks with the gemma extras (final softcap, embedding scale, QK-norm, a
global RoPE theta), MoE MLPs, deepseek's MLA layers and dense prologue, the
zamba2 hybrid's MAMBA and SHARED_ATTN layers, the xLSTM (MLSTM, SLSTM) and
classic LSTM stacks, and the modality stubs: musicgen's codebooks and
paligemma's prefix-LM with its vision prefix).

An arch is ``prologue`` (leading layers) followed by a repeating *period* of
layer kinds; the port runs the stack as a plain loop over ``num_layers``
layers, layer ``l`` having kind ``layer_kind(l)``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

ATTN = "attn"            # full causal attention + MLP
LOCAL = "local"          # sliding-window attention + MLP
MLA = "mla"              # multi-head latent attention (deepseek) + MoE/MLP
MAMBA = "mamba"          # mamba2 SSD block
SHARED_ATTN = "shared_attn"  # zamba2 shared transformer block (one weight copy)
MLSTM = "mlstm"          # xLSTM matrix-LSTM block
SLSTM = "slstm"          # xLSTM scalar-LSTM block
LSTM = "lstm"            # classic LSTM (paper's own PTB model)
KINDS = (ATTN, LOCAL, MLA, MAMBA, SHARED_ATTN, MLSTM, SLSTM, LSTM)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0           # routed experts
    experts_per_token: int = 0     # top-k
    num_shared_experts: int = 0
    d_ff: int = 0                  # per-expert hidden
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    group_size: int = 512          # tokens per dispatch group (GShard-style)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64           # N
    head_dim: int = 64            # P
    num_heads: int = 0            # filled from d_inner // head_dim if 0
    expand: int = 2               # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio |
                                  # vlm | lstm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads

    period: Sequence[str] = (ATTN,)
    prologue: Sequence[str] = ()  # leading layers outside the period
    prologue_d_ff: int = 0        # a prologue layer's dense MLP (deepseek)

    # attention details (the window and the softcap reach the decode kernel)
    use_paged_decode: bool = False  # decode reads KV through page pools
                                    # with ops.paged_decode_attention (the
                                    # engine's pools layout, paged=True)
    sliding_window: int = 0       # LOCAL layers' window
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0   # gemma3 global layers use a different theta
    prefix_lm: bool = False          # paligemma: bidirectional prefix

    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # modality stubs
    num_codebooks: int = 0        # musicgen: 4 EnCodec codebooks
    num_prefix_tokens: int = 0    # paligemma: SigLIP patch embeddings (stub)

    act: str = "silu"             # silu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    scale_embed: bool = False     # gemma family scales embeddings by sqrt(d)
    vocab_pad_to: int = 256       # embedding table padded to this multiple
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        unknown = (set(self.period) | set(self.prologue)) - set(KINDS)
        if unknown:
            raise ValueError(f"{self.name}: unknown layer kinds "
                             f"{sorted(unknown)}")
        assert self.num_layers >= len(self.prologue)
        n = self.num_layers - len(self.prologue)
        assert n % len(self.period) == 0, (
            f"{self.name}: {n} layers not divisible by period "
            f"{len(self.period)}")

    @property
    def period_len(self) -> int:
        return len(self.period)

    @property
    def num_periods(self) -> int:
        return (self.num_layers - len(self.prologue)) // len(self.period)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape: a recurrent kind in the
        period, or local attention there (gemma2/3 decode their local
        layers in O(window)), as the reference's."""
        kinds = set(self.period)
        if kinds & {MAMBA, MLSTM, SLSTM, LSTM}:
            return True
        return LOCAL in kinds

    def layer_kind(self, layer: int) -> str:
        """Kind of layer ``layer`` of the whole stack, prologue first."""
        n = len(self.prologue)
        if layer < n:
            return self.prologue[layer]
        return self.period[(layer - n) % len(self.period)]

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU tests (the reference's
        ``reduced()`` for the same arch, field for field)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=len(self.prologue) + 2 * self.period_len,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128,
            vocab_size=512,
            head_dim=16,
            prologue_d_ff=128 if self.prologue else 0,
            sliding_window=min(self.sliding_window, 8)
            if self.sliding_window else 0,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_dim=16 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            # capacity_factor high enough to be dropless at toy scale, as
            # the reference's
            moe=dataclasses.replace(self.moe, num_experts=4,
                                    experts_per_token=2, d_ff=64,
                                    capacity_factor=4.0)
            if self.moe else None,
            ssm=dataclasses.replace(self.ssm, state_dim=16, head_dim=8,
                                    num_heads=0, chunk=8)
            if self.ssm else None,
            num_prefix_tokens=4 if self.num_prefix_tokens else 0,
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # import the per-arch modules for their registration side effect
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_lite, gemma2_2b, gemma3_12b, granite_moe_3b,
        internlm2_1p8b, lstm_ptb, musicgen_medium, paligemma_3b, smollm_360m,
        xlstm_1p3b, zamba2_7b)


def cells(include_skips: bool = False):
    """All (arch, shape, skipped) dry-run cells, as the reference's: every
    arch but the paper's own lstm-ptb at every shape, long_500k only for a
    subquadratic arch unless ``include_skips``."""
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        if arch == "lstm-ptb":
            continue  # the paper's own model: not a dry-run cell
        for sname in SHAPES:
            skip = sname == "long_500k" and not cfg.subquadratic
            if skip and not include_skips:
                continue
            out.append((arch, sname, skip))
    return out
