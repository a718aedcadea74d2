"""ChatGLM3-6B [arXiv:2406.12793].

28L, d_model=4096, 32 heads (GQA kv=2), d_ff=13696, vocab=65024.
2D/partial RoPE (rotary applied to half the head dims), QKV bias.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Stage, register

CONFIG = register(ModelConfig(
    name="chatglm3-6b",
    family="dense",
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    stages=(Stage(pattern=(LayerSpec(kind="attn"),), repeat=28),),
    attention_kind="gqa",
    rope_kind="half",
    rope_theta=10000.0,
    qkv_bias=True,
    act="silu",
    norm_eps=1e-5,
    citation="arXiv:2406.12793",
))
