"""Mamba2-1.3B: attention-free SSD (state-space duality) stack.
[arXiv:2405.21060; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv=0,
    d_ff=0,                # SSD block is the whole layer (assignment: d_ff=0)
    vocab=50280,
    block_pattern=("s",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
    source="arXiv:2405.21060",
))
