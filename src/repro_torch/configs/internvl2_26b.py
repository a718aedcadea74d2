"""InternVL2-26B language backbone (InternLM2-20B) [arXiv:2404.16821].

48L, d_model=6144, 48 heads (GQA kv=8), d_ff=16384, vocab=92553.
The InternViT-6B vision encoder + MLP projector is the modality frontend
and is stubbed: input_specs() provides precomputed patch embeddings
interleaved with text tokens (see DESIGN.md carve-out).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Stage, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    stages=(Stage(pattern=(LayerSpec(kind="attn"),), repeat=48),),
    attention_kind="gqa",
    rope_kind="neox",
    rope_theta=1000000.0,
    act="silu",
    norm_eps=1e-5,
    embed_stub="vision",
    citation="arXiv:2404.16821",
))
