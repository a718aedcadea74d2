"""TinyLlama 1.1B [arXiv:2401.02385].

Llama-2 architecture at small scale: 22L, d_model=2048, 32 heads
(GQA kv=4), d_ff=5632, vocab=32000.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Stage, register

CONFIG = register(ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    stages=(Stage(pattern=(LayerSpec(kind="attn"),), repeat=22),),
    attention_kind="gqa",
    rope_kind="neox",
    rope_theta=10000.0,
    act="silu",
    norm_eps=1e-5,
    citation="arXiv:2401.02385",
))
