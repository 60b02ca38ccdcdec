"""Architecture config schema + registry for the 10 assigned architectures.

A copy of ``repro/configs/base.py`` (pure data): the port keeps its own so
that it imports nothing of the reference package.

Heterogeneous layer stacks are expressed as a repeating ``block_pattern`` of
layer *kinds* plus an optional ``tail_pattern`` (DESIGN.md §4, "block-scan"):

    kind  mixer                      channel mixer
    "g"   global self-attention      dense FFN
    "l"   sliding-window attention   dense FFN
    "m"   global self-attention      MoE FFN
    "x"   cross-attention            dense FFN      (VLM image layers)
    "r"   RG-LRU recurrent block     dense FFN      (Griffin)
    "s"   Mamba2 SSD block           (none; the SSD block is the layer)
    "e"   encoder self-attention     dense FFN      (non-causal; enc-dec)
    "d"   self-attn + cross-attn     dense FFN      (enc-dec decoder layer)

``n_layers * [pattern]`` must tile as  len(pattern) * n_units + len(tail).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

REGISTRY: dict[str, "ArchConfig"] = {}

_ARCH_MODULES = [
    "llama4_maverick_400b_a17b",
    "moonshot_v1_16b_a3b",
    "recurrentgemma_2b",
    "qwen3_0_6b",
    "qwen1_5_110b",
    "starcoder2_7b",
    "gemma3_1b",
    "mamba2_1_3b",
    "llama_3_2_vision_90b",
    "seamless_m4t_large_v2",
]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int                     # decoder layers (enc-dec: decoder side)
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: int = 0                   # sliding-window size for "l" layers
    # stack pattern
    block_pattern: Tuple[str, ...] = ("g",)
    tail_pattern: Tuple[str, ...] = ()
    # FFN
    gated_ffn: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    moe_dff: int = 0                  # expert hidden dim (defaults to d_ff)
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # RG-LRU (recurrentgemma)
    rnn_width: int = 0                # 0 -> d_model
    # encoder (enc-dec archs)
    enc_layers: int = 0
    enc_causal: bool = False
    # modality frontend stub
    frontend: str | None = None       # "vision" | "audio"
    n_frontend_tokens: int = 0
    # numerics / training
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"  # bf16 for the >=90B configs (DESIGN §5)
    remat: bool = True
    tie_embeddings: bool = True
    # distribution
    fsdp: bool = False                # shard params/opt over the data axis
    # notes for DESIGN/EXPERIMENTS
    source: str = ""

    def __post_init__(self):
        unit = len(self.block_pattern)
        tail = len(self.tail_pattern)
        if (self.n_layers - tail) % unit != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} != "
                f"{unit}*k + {tail} (pattern {self.block_pattern} + tail)")

    @property
    def n_units(self) -> int:
        return (self.n_layers - len(self.tail_pattern)) // len(self.block_pattern)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def resolved_moe_dff(self) -> int:
        return self.moe_dff or self.d_ff

    @property
    def resolved_rnn_width(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode (DESIGN §4 skip rule)."""
        kinds = set(self.block_pattern) | set(self.tail_pattern)
        return ("g" not in kinds and "m" not in kinds and "d" not in kinds) or (
            "l" in kinds and self.window > 0)


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not REGISTRY:
        load_all()
    key = name.replace("_", "-")
    if key not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[key]


def load_all() -> dict[str, ArchConfig]:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"{__package__}.{mod}")
    return dict(REGISTRY)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests: keeps the layer *pattern*
    and every architectural flag, shrinks all dimensions."""
    unit = len(cfg.block_pattern)
    tail = len(cfg.tail_pattern)
    defaults = dict(
        name=cfg.name + "-smoke",
        n_layers=2 * unit + tail,
        d_model=64,
        n_heads=4,
        n_kv=min(cfg.n_kv, 4) if cfg.n_kv else 0,
        head_dim=16,
        d_ff=128,
        moe_dff=32 if cfg.moe_dff else 0,
        vocab=256,
        n_experts=min(cfg.n_experts, 8),
        ssm_state=min(cfg.ssm_state, 16),
        ssm_chunk=8,
        rnn_width=32 if cfg.rnn_width or cfg.family == "hybrid" else 0,
        window=min(cfg.window, 8),
        enc_layers=2 if cfg.enc_layers else 0,
        n_frontend_tokens=8 if cfg.n_frontend_tokens else 0,
        param_dtype="float32",
        compute_dtype="float32",
        opt_state_dtype="float32",
        remat=False,
        fsdp=False,
    )
    defaults.update(overrides)
    return dataclasses.replace(cfg, **defaults)
