"""RWKV-6 (Finch) 3B [arXiv:2404.05892].

Attention-free RNN with data-dependent decay (dynamic recurrence).
32L, d_model=2560 (40 heads x 64), channel-mix d_ff=8960, vocab=65536.
Decode is O(1) in sequence length (per-layer matrix state), which is why
this arch runs the long_500k shape.
"""
from repro_torch.configs.base import (LayerSpec, ModelConfig, SSMConfig, Stage,
                                      register)

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    stages=(Stage(pattern=(LayerSpec(kind="rwkv"),), repeat=32),),
    attention_kind="none",
    rope_kind="none",
    ssm=SSMConfig(kind="rwkv6", head_dim=64, lora_rank=32),
    act="silu",
    norm_eps=1e-5,
    citation="arXiv:2404.05892",
))
