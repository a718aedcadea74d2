"""Composable decoder model: init + apply for every configuration
(PyTorch counterpart of ``repro/models/transformer.py``).

Params keep the reference's pytree layout, as a nested dict of tensors:
``{'embed', 'final_norm', 'lm_head'?, 'stages': [[elem, ...], ...]}``
where each stage element's tensors carry a leading ``repeat`` axis (the
reference's ``jax.vmap`` init). ``apply_model`` walks the repeats in a
Python loop where the reference scans. The same call serves training
(cache=None, full causal), chunked prefill (cache + pos offset — Teola's
Partial/Full Prefilling) and decode (S == 1).

A layer is GQA or MLA attention (``models/attention.py``), in a hybrid
layer fused with a parallel Mamba branch (Hymba), followed by a dense or
a mixture-of-experts FFN (``models/moe.py``); or an RWKV-6 layer. Inputs
are tokens, or float embeddings ``(B, S, d)`` for the configurations
whose modality frontend is stubbed (``embed_stub``).

``block_tables`` switches the cache to the paged pool (serving/
kv_cache.py); ``verify=True`` marks a speculative verify chunk on it.

Recurrent layers (RWKV-6, the Mamba branch) keep a per-sequence state in
the dense cache (``state``, ``sx_tm``, ``sx_cm``; ``ssm_h``, ``ssm_conv``),
updated in place; they ignore ``pos``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.common import (act_fn, dense_init, embed_init,
                                       rms_norm, softcap, tree_map)


# ---------------------------------------------------------------------------
# init

def init_layer_elem(generator, cfg: ModelConfig, spec: LayerSpec, dtype,
                    device, repeat: int):
    d, f = cfg.d_model, cfg.d_ff

    def zeros():
        return torch.zeros((repeat, d), dtype=dtype, device=device)

    p = {"ln1": zeros(), "ln2": zeros()}
    if spec.kind == "rwkv":
        p.update(ssm.init_rwkv_params(generator, cfg, dtype, device, repeat))
        return p
    init_attn = attn.init_mla_params if cfg.attention_kind == "mla" else \
        attn.init_gqa_params
    p["attn"] = init_attn(generator, cfg, dtype, device, repeat)
    if spec.kind == "hybrid":
        p["mamba"] = ssm.init_mamba_params(generator, cfg, dtype, device,
                                           repeat)
        p["fuse_na"] = zeros()
        p["fuse_ns"] = zeros()
    if spec.moe:
        p["moe"] = moe.init_moe_params(generator, cfg, dtype, device, repeat)
    else:
        p["mlp"] = {
            "w_gate": dense_init(generator, (repeat, d, f), dtype, device,
                                 fan_in=d),
            "w_up": dense_init(generator, (repeat, d, f), dtype, device,
                               fan_in=d),
            "w_down": dense_init(generator, (repeat, f, d), dtype, device,
                                 fan_in=f),
        }
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda"):
    """Random weights with the reference ``init_params``'s shapes and
    scales, drawn from ``generator`` on the generator's device and placed
    on ``device``."""
    params = {"embed": embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                  dtype, device),
              "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype, device)
    params["stages"] = [
        [init_layer_elem(generator, cfg, spec, dtype, device, st.repeat)
         for spec in st.pattern]
        for st in cfg.stages]
    return params


# ---------------------------------------------------------------------------
# apply

def _ffn(cfg, p, x):
    act = act_fn(cfg.act)
    h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def _rwkv_layer(cfg, p, x, ce):
    """norm -> time mix -> residual, norm -> channel mix -> residual. With
    a cache elem the new state and token-shift rows are written into its
    views in place; without one the state starts at zeros."""
    B, _, d = x.shape
    if ce is None:
        hd = cfg.ssm.head_dim
        state = torch.zeros((B, d // hd, hd, hd), dtype=torch.float32,
                            device=x.device)
        sx_tm = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        sx_cm = torch.zeros_like(sx_tm)
    else:
        state, sx_tm, sx_cm = ce["state"], ce["sx_tm"], ce["sx_cm"]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out, _, new_sx_tm = ssm.rwkv_time_mix(
        cfg, p["tm"], h, state, sx_tm,
        out_state=None if ce is None else state)
    x = x + out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    out, new_sx_cm = ssm.rwkv_channel_mix(cfg, p["cm"], h, sx_cm)
    x = x + out
    if ce is not None:
        sx_tm.copy_(new_sx_tm)
        sx_cm.copy_(new_sx_cm)
    return x, ce


def _hybrid_state(cfg, ce, B, device):
    """The Mamba branch's (h, conv) state: the cache's views, or zeros."""
    if ce is not None:
        return ce["ssm_h"], ce["ssm_conv"]
    s, d = cfg.ssm, cfg.d_model
    return (torch.zeros((B, d, s.state_dim), dtype=torch.float32,
                        device=device),
            torch.zeros((B, s.conv_dim - 1, d), dtype=torch.float32,
                        device=device))


def apply_layer(cfg, spec, p, x, ce, pos, block_tables=None, verify=False):
    """One transformer layer. ce: cache elem dict or None (paged pool
    elems when ``block_tables`` is given). Returns (x, new_cache_elem,
    aux_loss), the cache elem updated in place."""
    if spec.kind == "rwkv":
        return (*_rwkv_layer(cfg, p, x, ce), None)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attention_kind == "mla":
        a_out, _ = attn.mla_layer(cfg, spec, p["attn"], h, ce, pos,
                                  block_tables)
    else:
        a_out, _ = attn.gqa_layer(cfg, spec, p["attn"], h, ce, pos,
                                  block_tables, verify)
    if spec.kind == "hybrid":
        h_state, conv_state = _hybrid_state(cfg, ce, x.shape[0], x.device)
        s_out, new_h, new_conv = ssm.mamba_branch(cfg, p["mamba"], h,
                                                  h_state, conv_state)
        if ce is not None:
            h_state.copy_(new_h)
            conv_state.copy_(new_conv)
        x = x + 0.5 * (rms_norm(a_out, p["fuse_na"], cfg.norm_eps)
                       + rms_norm(s_out, p["fuse_ns"], cfg.norm_eps))
    else:
        x = x + a_out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.moe:
        f_out, aux = moe.moe_ffn(cfg, p["moe"], h)
    else:
        f_out, aux = _ffn(cfg, p["mlp"], h), None
    return x + f_out, ce, aux


def _unstack(tree, n):
    """The ``n`` per-layer trees of a stacked stage element: every leaf
    unbound along its leading ``repeat`` axis (views). Under autograd one
    unbind per leaf gathers the layers' gradients into one stacked
    gradient, where indexing each layer would materialise a zero-filled
    copy of the whole stacked leaf per layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, n) for v in tree]
        return [[p[r] for p in parts] for r in range(n)]
    return tree.unbind(0)


def apply_model(cfg: ModelConfig, params, inputs, cache=None, pos=0, *,
                logits_slice=None, logits_at=None, block_tables=None,
                verify=False, return_aux=False):
    """inputs: int tokens (B,S), or float embeddings (B,S,d) for the
    configurations whose modality frontend is stubbed. Returns (logits,
    cache), or (logits, cache, aux) with ``return_aux``.

    cache/pos implement chunked (partial) prefill and decode (the cache is
    updated in place and returned); cache=None is training/eval over the
    full sequence. ``block_tables`` (B,maxblk) switches the cache to the
    PAGED layout (shared block pools indexed per sequence); ``verify``
    routes a paged chunk through the speculative verify kernel.
    ``logits_at`` (B,) computes the head only at one per-sequence chunk
    index (exact last-token logits under right-padded bucketed prefill),
    returning (B,1,vocab). ``aux`` is the sum of the MoE layers'
    load-balance losses (float32; 0 without MoE layers), the reference's
    third return value, which training adds to the loss."""
    if inputs.is_floating_point():
        x = inputs.to(params["embed"].dtype)
    else:
        x = params["embed"][inputs.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=x.device, dtype=torch.int32)
    if block_tables is not None:
        block_tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                       device=x.device)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device) \
        if return_aux else None
    for si, st in enumerate(cfg.stages):
        layers = [_unstack(e, st.repeat) for e in params["stages"][si]]
        cache_st = cache["stages"][si] if cache is not None else None
        for r in range(st.repeat):
            for ei, spec in enumerate(st.pattern):
                ce = None if cache_st is None else \
                    tree_map(lambda t: t[r], cache_st[ei])
                x, _, aux = apply_layer(cfg, spec, layers[ei][r], x, ce,
                                        pos, block_tables, verify)
                if return_aux and aux is not None:
                    aux_total = aux_total + aux

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_at is not None:
        logits_at = torch.as_tensor(logits_at, device=x.device).long()
        x = x[torch.arange(x.shape[0], device=x.device), logits_at][:, None]
    elif logits_slice is not None:
        x = x[:, -logits_slice:, :]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    logits = softcap(logits, cfg.final_logit_softcap)
    if return_aux:
        return logits, cache, aux_total
    return logits, cache
