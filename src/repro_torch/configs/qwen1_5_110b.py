"""Qwen1.5-110B: dense, GQA kv=8, QKV bias.  [hf:Qwen/Qwen1.5-110B; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=49152,
    vocab=152064,
    rope_theta=1e6,
    qkv_bias=True,
    block_pattern=("g",),
    opt_state_dtype="bfloat16",
    fsdp=True,
    source="hf:Qwen/Qwen1.5-110B",
))
