"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model=2048, 16 heads (MHA: kv=16), vocab=151936. Every layer MoE:
60 routed experts top-4 (expert dim 1408) + 4 shared experts
(shared intermediate 5632 total). Gate probs not re-normalized after top-k.
"""
from repro_torch.configs.base import (LayerSpec, MoEConfig, ModelConfig, Stage,
                                      register)

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=5632,                     # shared-expert path width
    vocab_size=151936,
    stages=(Stage(pattern=(LayerSpec(kind="attn", moe=True),), repeat=24),),
    attention_kind="gqa",
    rope_kind="neox",
    rope_theta=1000000.0,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408,
                  num_shared_experts=4, d_shared=5632,
                  capacity_factor=1.25, norm_topk_prob=False),
    act="silu",
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
