"""Gemma-2 9B [arXiv:2408.00118].

42L, d_model=3584, 16 heads (GQA kv=8), head_dim=256, d_ff=14336,
vocab=256000. Alternating local (4096-token sliding window) and global
attention layers; attention-logit softcap 50, final-logit softcap 30;
query scale 1/sqrt(query_pre_attn_scalar=256); sqrt(d) embedding scaling.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Stage, register

CONFIG = register(ModelConfig(
    name="gemma2-9b",
    family="dense",
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    stages=(Stage(pattern=(LayerSpec(kind="attn", window=4096),
                           LayerSpec(kind="attn")), repeat=21),),
    attention_kind="gqa",
    rope_kind="neox",
    rope_theta=10000.0,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    attn_scale=256 ** -0.5,
    embed_scale=True,
    act="gelu",
    tie_embeddings=True,
    citation="arXiv:2408.00118",
))
