"""Gemma3-1B: 5:1 local:global attention, MQA kv=1, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    rope_theta=1e6,
    qk_norm=True,
    window=1024,
    # 5 local : 1 global -> (l,l,l,l,l,g) x 4 + (l,l) = 26 layers.
    block_pattern=("l", "l", "l", "l", "l", "g"),
    tail_pattern=("l", "l"),
    source="hf:google/gemma-3-1b-pt",
))
