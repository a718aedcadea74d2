"""DeepSeek 67B [arXiv:2401.02954].

Llama-architecture dense model: 95L, d_model=8192, 64 heads (GQA kv=8),
d_ff=22016, vocab=102400.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Stage, register

CONFIG = register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    stages=(Stage(pattern=(LayerSpec(kind="attn"),), repeat=95),),
    attention_kind="gqa",
    rope_kind="neox",
    rope_theta=10000.0,
    act="silu",
    norm_eps=1e-6,
    citation="arXiv:2401.02954",
))
