"""Model configuration system.

Every assigned architecture is expressed as a ModelConfig: a sequence of
*stages*, each stage being a repeating *pattern* of LayerSpecs. Stages are
scanned over their repeat count with stacked weights so HLO size is
independent of layer count; heterogeneous layouts (e.g. Gemma-2's
local/global alternation, DeepSeek-V3's leading dense layers) are expressed
as multi-element patterns or multiple stages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    num_shared_experts: int = 0
    d_shared: int = 0             # total shared-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    # normalize top-k gate weights (deepseek-v3 style) vs plain softmax probs
    norm_topk_prob: bool = True


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"           # "mamba" | "rwkv6"
    state_dim: int = 16           # N for mamba; head_dim implied for rwkv6
    head_dim: int = 64            # rwkv6 per-head k/v dim
    dt_rank: int = 32
    lora_rank: int = 32           # rwkv6 data-dependent decay LoRA rank
    conv_dim: int = 4             # mamba local conv width


@dataclass(frozen=True)
class LayerSpec:
    """One layer's shape. kind:
    - 'attn':   norm -> attention -> residual, norm -> ffn -> residual
    - 'rwkv':   norm -> rwkv time-mix -> residual, norm -> channel-mix -> res
    - 'hybrid': norm -> (attention || ssm heads, fused) -> residual, ffn
    """
    kind: str = "attn"
    window: Optional[int] = None   # sliding window (tokens); None = full attn
    moe: bool = False              # FFN is mixture-of-experts


@dataclass(frozen=True)
class Stage:
    pattern: Tuple[LayerSpec, ...]
    repeat: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeat


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    stages: Tuple[Stage, ...]
    head_dim: Optional[int] = None          # default d_model // num_heads
    # attention details
    attention_kind: str = "gqa"             # gqa | mla | none
    rope_kind: str = "neox"                 # neox | half | none
    rope_theta: float = 10000.0
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    attn_scale: Optional[float] = None      # override 1/sqrt(head_dim)
    embed_scale: bool = False               # gemma-style sqrt(d) embed scaling
    qkv_bias: bool = False                  # chatglm3 uses qkv bias
    # ffn
    act: str = "silu"                       # silu | gelu
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # modality frontend stub: inputs are precomputed embeddings, not tokens
    embed_stub: Optional[str] = None        # None | 'audio' | 'vision'
    citation: str = ""

    @property
    def num_layers(self) -> int:
        return sum(s.num_layers for s in self.stages)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for st in self.stages:
            for spec in st.pattern:
                ln = 2 * d
                if spec.kind == "rwkv":
                    s = self.ssm
                    # time-mix: r,k,v,g,o projections + decay lora + ffn
                    tm = 5 * d * d + 2 * s.lora_rank * d * 6
                    cm = 2 * d * self.d_ff + d * self.d_ff
                    n += st.repeat * (tm + cm + ln)
                    continue
                # attention params
                if self.attention_kind == "mla":
                    m = self.mla
                    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                    attn = (d * m.q_lora_rank
                            + m.q_lora_rank * self.num_heads * qk_hd
                            + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                            + m.kv_lora_rank * self.num_heads
                            * (m.qk_nope_head_dim + m.v_head_dim)
                            + self.num_heads * m.v_head_dim * d)
                else:
                    attn = (d * self.num_heads * hd
                            + 2 * d * self.num_kv_heads * hd
                            + self.num_heads * hd * d)
                if spec.kind == "hybrid":
                    s = self.ssm
                    attn += 2 * d * d + 2 * d * s.state_dim * 2  # ssm branch
                # ffn params
                if spec.moe:
                    mo = self.moe
                    ffn = mo.num_experts * 3 * d * mo.d_expert + d * mo.num_experts
                    if mo.num_shared_experts:
                        ffn += 3 * d * mo.d_shared
                else:
                    ffn = 3 * d * self.d_ff
                n += st.repeat * (attn + ffn + ln)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        n = self.param_count()
        mo = self.moe
        d = self.d_model
        for st in self.stages:
            for spec in st.pattern:
                if spec.moe:
                    dead = (mo.num_experts - mo.top_k) * 3 * d * mo.d_expert
                    n -= st.repeat * dead
        return n

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized variant of the same family: 2 layers,
        d_model<=512, <=4 experts, tiny vocab."""
        d = min(self.d_model, 256)
        hd = 64
        nh = max(2, min(4, self.num_heads))
        nkv = max(1, min(nh, self.num_kv_heads if self.num_kv_heads else nh))
        while nh % nkv:
            nkv -= 1
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, num_experts=4, top_k=min(2, moe.top_k),
                d_expert=128, d_shared=128 if moe.num_shared_experts else 0,
                num_shared_experts=min(1, moe.num_shared_experts))
        mla = self.mla
        if mla is not None:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                            qk_nope_head_dim=32, qk_rope_head_dim=16,
                            v_head_dim=32)
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, state_dim=8, head_dim=32,
                                      dt_rank=8, lora_rank=8)
        # keep each distinct pattern once, repeat 1 (>=2 layers if pattern>=2)
        stages = []
        seen = set()
        for st in self.stages:
            key = tuple((sp.kind, sp.window is not None, sp.moe)
                        for sp in st.pattern)
            if key in seen:
                continue
            seen.add(key)
            pat = tuple(dataclasses.replace(
                sp, window=min(sp.window, 64) if sp.window else None)
                for sp in st.pattern)
            stages.append(Stage(pattern=pat, repeat=1))
        if sum(s.num_layers for s in stages) < 2:
            stages = [Stage(pattern=stages[0].pattern, repeat=2)]
        kw = dict(
            name=self.name + "-smoke", family=self.family,
            d_model=d, num_heads=nh, num_kv_heads=nkv, head_dim=hd,
            d_ff=min(self.d_ff, 512), vocab_size=min(self.vocab_size, 1024),
            stages=tuple(stages),
            attention_kind=self.attention_kind, rope_kind=self.rope_kind,
            rope_theta=self.rope_theta,
            attn_logit_softcap=self.attn_logit_softcap,
            final_logit_softcap=self.final_logit_softcap,
            attn_scale=None, embed_scale=self.embed_scale,
            qkv_bias=self.qkv_bias, act=self.act,
            moe=moe, mla=mla, ssm=ssm, norm_eps=self.norm_eps,
            tie_embeddings=self.tie_embeddings, embed_stub=self.embed_stub,
            citation=self.citation,
        )
        kw.update(overrides)
        return ModelConfig(**kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


ARCH_MODULES = [
    "musicgen_medium", "gemma2_9b", "chatglm3_6b", "tinyllama_1_1b",
    "internvl2_26b", "hymba_1_5b", "deepseek_v3_671b", "qwen2_moe_a2_7b",
    "deepseek_67b", "rwkv6_3b", "engines_tiny",
]


def load_all():
    import importlib
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
