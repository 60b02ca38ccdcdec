"""Qwen3-0.6B: dense, GQA kv=8, QK-norm.  [hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv=8,
    head_dim=128,
    d_ff=3072,
    vocab=151936,
    rope_theta=1e6,
    qk_norm=True,
    block_pattern=("g",),
    source="hf:Qwen/Qwen3-0.6B family",
))
