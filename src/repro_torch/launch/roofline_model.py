"""Analytic roofline cost model (PyTorch counterpart of the analytic half
of ``repro/launch/roofline_model.py``).

The compute and memory terms come from the config and input shape,
mirroring what the implemented program does: full S^2 masked attention,
or under the ``causal_skip`` flag the reference's count of the blocks on
and below the diagonal (Skv / 2 + 256 keys per query), which the port's
query-block loop computes (``models/attention.py::_gqa_causal_skip``);
absorbed-MLA score FLOPs at the kv_lora rank. The FLOP and byte terms do not depend on the
hardware; ``launch/mesh.py`` holds the H100's peaks that divide them.

Not ported: the reference's HLO-text parsers (``collective_bytes_*``,
``trips_for_case``, ``loop_multiplier``). They read XLA's HLO, which the
port does not have, and exist because XLA's cost analysis counts a
while-loop body once. The port runs eagerly, so ``models/sharding.py``'s
counter sees each collective every time it is issued and needs no trip
correction.
"""
from __future__ import annotations

from repro_torch.configs.base import InputShape, ModelConfig


def _attn_flops_per_layer(cfg: ModelConfig, spec, B, Sq, Skv):
    """Score+context matmul FLOPs for ONE layer (fwd), as implemented:
    full Skv attended (masked), or under ``causal_skip`` the blocks on and
    below the diagonal of full causal self-attention."""
    hd = cfg.resolved_head_dim
    H = cfg.num_heads
    if cfg.attention_kind == "mla":
        m = cfg.mla
        r, p = m.kv_lora_rank, m.qk_rope_head_dim
        # absorbed: q_eff einsum + scores(r) + rope scores(p) + ctx(r) +
        # out einsum
        return 2 * B * Sq * H * (m.qk_nope_head_dim * r        # q_eff
                                 + Skv * (r + p)               # scores
                                 + Skv * r                     # ctx
                                 + r * m.v_head_dim)           # out_h
    if spec.kind == "rwkv":
        s = cfg.ssm
        heads = cfg.d_model // s.head_dim
        # per-step state update + readout: ~4 * hd^2 per head per token
        return 4 * B * Sq * heads * s.head_dim * s.head_dim * 2
    from repro_torch.launch import optflags
    win = spec.window
    eff_kv = min(Skv, win) if win else Skv
    if optflags.has("causal_skip") and Sq == Skv and not win:
        eff_kv = Skv * 0.5 + 256            # lower-triangular blocks only
    fl = 2 * B * H * Sq * eff_kv * hd * 2       # QK^T and PV
    if spec.kind == "hybrid":
        s = cfg.ssm
        fl += 6 * B * Sq * cfg.d_model * s.state_dim  # selective scan
    return fl


def linear_flops(cfg: ModelConfig, tokens: int) -> float:
    """Matmul-parameter FLOPs (2*N_active_linear per token), excluding the
    embedding gather but including the LM head."""
    n = cfg.active_param_count()
    n -= cfg.vocab_size * cfg.d_model       # embedding lookup isn't matmul
    if cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model   # tied head still multiplies
    return 2.0 * n * tokens


def analytic_flops(cfg: ModelConfig, ishape: InputShape) -> float:
    """Global forward(+backward) FLOPs for one step, as implemented."""
    B, S = ishape.global_batch, ishape.seq_len
    if ishape.mode == "decode":
        Sq, Skv, tokens = 1, S, B
    else:
        Sq, Skv, tokens = S, S, B * S
    total = linear_flops(cfg, tokens)
    for st in cfg.stages:
        for spec in st.pattern:
            total += st.repeat * _attn_flops_per_layer(cfg, spec, B, Sq,
                                                       Skv)
    if ishape.mode == "train":
        total *= 3.0                        # fwd + bwd
    return total


def param_bytes(cfg: ModelConfig, dtype_bytes: int) -> float:
    return cfg.param_count() * dtype_bytes


def analytic_bytes(cfg: ModelConfig, ishape: InputShape, n_devices: int,
                   dtype_bytes: int = 2) -> float:
    """Per-DEVICE HBM traffic estimate for one step, with weights,
    compute copies and activations ``dtype_bytes`` wide (2: the
    reference's bf16, where this equals the reference exactly; 4: what
    the port's fp32 paths read).
    serve: sharded weights read once + KV cache read/write + activations.
    train: fp32 master + compute copies + grads + 2x moments r/w,
    weights re-read in backward, activations saved+reread (remat'd layer
    inputs only)."""
    from repro_torch.serving.kv_cache import cache_bytes
    B, S = ishape.global_batch, ishape.seq_len
    d = cfg.d_model
    L = cfg.num_layers
    w_elem = act_elem = dtype_bytes
    if ishape.mode == "decode":
        w = param_bytes(cfg, w_elem) / n_devices     # weights
        kv = cache_bytes(cfg, B, S) / n_devices      # read full cache
        act = B * d * L * 12 * act_elem / n_devices
        return w + kv + act
    if ishape.mode == "prefill":
        w = param_bytes(cfg, w_elem) / n_devices
        kv = cache_bytes(cfg, B, S) / n_devices      # write cache
        act = B * S * d * L * 12 * act_elem / n_devices
        return w + kv + act
    # train
    wmaster = param_bytes(cfg, 4) / n_devices
    wcompute = param_bytes(cfg, w_elem) / n_devices
    moments = 2 * param_bytes(cfg, w_elem) / n_devices  # m, v r+w -> x2
    grads = param_bytes(cfg, 4) / n_devices
    act = B * S * d * L * (12 + 12) * act_elem / n_devices  # fwd + remat
    return 2 * wmaster + 2 * wcompute + 2 * moments + 2 * grads + act


def roofline_terms(flops: float, nbytes: float, coll_bytes: float,
                   peak_flops: float) -> dict:
    """Seconds of each term on one H100 (``launch/mesh.py``'s peaks),
    ``peak_flops`` the peak of the dtype the step computes in."""
    from repro_torch.launch.mesh import HBM_BW, NVLINK_BW
    return {"compute_s": flops / peak_flops, "memory_s": nbytes / HBM_BW,
            "collective_s": coll_bytes / NVLINK_BW}
