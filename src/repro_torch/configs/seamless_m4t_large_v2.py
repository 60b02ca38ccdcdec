"""SeamlessM4T-large-v2 text backbone: encoder-decoder transformer, MHA,
non-gated FFN.  The speech frontend is a STUB: ``input_specs`` provides
precomputed frame embeddings for the encoder.  [arXiv:2308.11596; hf]

Shape convention (DESIGN.md §4): for *_Sk shapes the encoder consumes S
frame embeddings and the decoder S//4 text tokens.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,               # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    gated_ffn=False,
    block_pattern=("d",),      # decoder: self + cross + FFN
    enc_layers=24,
    frontend="audio",
    n_frontend_tokens=0,       # encoder length comes from the shape spec
    tie_embeddings=True,
    source="arXiv:2308.11596",
))
