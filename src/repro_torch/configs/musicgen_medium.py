"""MusicGen-medium decoder backbone [arXiv:2306.05284].

Decoder-only transformer over EnCodec tokens. 48L, d_model=1536, 24 heads
(GQA kv=24, i.e. MHA), d_ff=6144, vocab=2048 (one EnCodec codebook's
cardinality). The EnCodec conv codec + delay-pattern interleaving is the
modality frontend and is stubbed: input_specs() provides precomputed frame
embeddings (see DESIGN.md carve-out).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Stage, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    stages=(Stage(pattern=(LayerSpec(kind="attn"),), repeat=48),),
    attention_kind="gqa",
    rope_kind="none",            # musicgen uses learned/sinusoidal pos-emb
    act="gelu",
    norm_eps=1e-5,
    embed_stub="audio",
    citation="arXiv:2306.05284",
))
