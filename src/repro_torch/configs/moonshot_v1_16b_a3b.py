"""Moonshot v1 16B-A3B (Moonlight-style): fine-grained MoE, 64 experts top-6,
MHA (kv=16).  [hf:moonshotai/Moonlight-16B-A3B; hf]

Note: with the assigned dims (48L, all-MoE, 64 x d_ff=1408 experts) total
params land at ~27B with ~3.3B active; we implement the assignment exactly
(DESIGN.md §4).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    head_dim=128,
    d_ff=1408,            # expert hidden dim
    moe_dff=1408,
    vocab=163840,
    rope_theta=5e4,
    block_pattern=("m",),
    n_experts=64,
    top_k=6,
    shared_expert=True,   # Moonlight keeps shared experts
    capacity_factor=1.25,
    fsdp=True,
    source="hf:moonshotai/Moonlight-16B-A3B",
))
