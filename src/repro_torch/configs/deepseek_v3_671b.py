"""DeepSeek-V3 671B [arXiv:2412.19437].

61L, d_model=7168, 128 heads with Multi-head Latent Attention (MLA:
q_lora 1536, kv_lora 512, nope 128 + rope 64 head dims, v 128),
vocab=129280. First 3 layers dense FFN (d_ff=18432); remaining 58 are MoE
with 1 shared + 256 routed experts (top-8), expert dim 2048.
MTP (multi-token prediction) is a training-objective add-on orthogonal to
the orchestration technique; see DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import (LayerSpec, MLAConfig, MoEConfig, ModelConfig,
                                      Stage, register)

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,                    # dense layers; experts use moe.d_expert
    vocab_size=129280,
    stages=(
        Stage(pattern=(LayerSpec(kind="attn", moe=False),), repeat=3),
        Stage(pattern=(LayerSpec(kind="attn", moe=True),), repeat=58),
    ),
    attention_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                  num_shared_experts=1, d_shared=2048,
                  capacity_factor=1.25, norm_topk_prob=True),
    rope_kind="neox",
    rope_theta=10000.0,
    act="silu",
    citation="arXiv:2412.19437",
))
