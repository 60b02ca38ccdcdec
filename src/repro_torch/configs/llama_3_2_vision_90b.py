"""Llama-3.2-Vision-90B text backbone with interleaved cross-attention image
layers (every 5th layer).  The vision encoder is a STUB: ``input_specs``
provides precomputed patch embeddings.  [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    rope_theta=5e5,
    # (self x4, cross) x 20 = 100 layers.
    block_pattern=("g", "g", "g", "g", "x"),
    frontend="vision",
    n_frontend_tokens=1024,   # patch embeddings per example (stub frontend)
    opt_state_dtype="bfloat16",
    fsdp=True,
    source="hf:meta-llama/Llama-3.2-90B-Vision (backbone only)",
))
