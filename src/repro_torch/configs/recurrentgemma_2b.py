"""RecurrentGemma-2B (Griffin): RG-LRU recurrent blocks + local attention,
1 attention per 2 recurrent layers, MQA kv=1.  [arXiv:2402.19427; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    window=2048,
    # Griffin pattern (R, R, A) x 8 + trailing (R, R) = 26 layers exactly.
    block_pattern=("r", "r", "l"),
    tail_pattern=("r", "r"),
    rnn_width=2560,
    conv_width=4,
    source="arXiv:2402.19427",
))
