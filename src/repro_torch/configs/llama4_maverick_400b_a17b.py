"""Llama-4 Maverick 400B-A17B: alternating dense/MoE layers, 128 experts
top-1 + shared expert, GQA kv=8, early-fusion multimodal (text backbone here).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    rope_theta=5e5,
    # 24 x (dense layer, MoE layer): the interleave that lands total params
    # at ~400B with 128 routed experts (d_ff = 8192 for both halves).
    block_pattern=("g", "m"),
    n_experts=128,
    top_k=1,
    shared_expert=True,
    capacity_factor=1.25,
    opt_state_dtype="bfloat16",   # 400B: fp32 moments cannot fit 256x16GB
    fsdp=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (scaled per assignment)",
))
