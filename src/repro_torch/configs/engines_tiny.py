"""Tiny engine-scale model configs used by the Teola runtime on CPU.

These power the *runnable* examples and benchmarks (the paper's workflows
executed end-to-end in this container). The assigned full-scale archs are
exercised via the AOT dry-run instead.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, Stage, register

# Core LLM engine model (llama-style, ~12M params)
CORE_LLM = register(ModelConfig(
    name="tiny-core-llm",
    family="dense",
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=704,
    vocab_size=4096,
    stages=(Stage(pattern=(LayerSpec(kind="attn"),), repeat=4),),
    attention_kind="gqa",
    rope_kind="neox",
    act="silu",
    citation="(engine-scale stand-in for llama-2-7B/13B/30B core LLMs)",
))

# Lightweight contextualizer LLM (gemma-2-2B stand-in)
LITE_LLM = register(ModelConfig(
    name="tiny-lite-llm",
    family="dense",
    d_model=128,
    num_heads=2,
    num_kv_heads=1,
    head_dim=64,
    d_ff=384,
    vocab_size=4096,
    stages=(Stage(pattern=(LayerSpec(kind="attn", window=64),
                           LayerSpec(kind="attn")), repeat=1),),
    attention_kind="gqa",
    rope_kind="neox",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="gelu",
    citation="(engine-scale stand-in for gemma-2-2B contextualizer)",
))
