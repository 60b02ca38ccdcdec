"""StarCoder2-7B: dense, GQA kv=4, RoPE, non-gated MLP.
[arXiv:2402.19173; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    rope_theta=1e5,
    qkv_bias=True,
    gated_ffn=False,       # classic gelu MLP (lands at ~7B)
    block_pattern=("g",),
    source="arXiv:2402.19173",
))
