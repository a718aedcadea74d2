"""Hymba-1.5B [arXiv:2411.13676].

Hybrid-head architecture: every layer runs attention heads and Mamba
(SSM) heads in PARALLEL on the same input, outputs normalized and fused.
32L, d_model=1600, 25 attention heads (GQA kv=5, head_dim=64), d_ff=5504,
vocab=32001, ssm_state=16. Hymba uses sliding-window attention on all but
three layers; we model all layers with a 2048-token window (simplification
recorded in DESIGN.md), which is what makes long_500k decode tractable.
"""
from repro_torch.configs.base import (LayerSpec, ModelConfig, SSMConfig, Stage,
                                      register)

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    stages=(Stage(pattern=(LayerSpec(kind="hybrid", window=2048),),
                  repeat=32),),
    attention_kind="gqa",
    rope_kind="neox",
    rope_theta=10000.0,
    act="silu",
    ssm=SSMConfig(kind="mamba", state_dim=16, dt_rank=32, conv_dim=4),
    norm_eps=1e-5,
    citation="arXiv:2411.13676",
))
