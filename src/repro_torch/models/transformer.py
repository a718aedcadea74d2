"""Dense decoder model: init + apply (PyTorch counterpart of
``repro/models/transformer.py`` for GQA attention layers with a dense FFN
and RWKV-6 layers).

Params keep the reference's pytree layout, as a nested dict of tensors:
``{'embed', 'final_norm', 'lm_head'?, 'stages': [[elem, ...], ...]}``
where each stage element's tensors carry a leading ``repeat`` axis (the
reference's ``jax.vmap`` init). ``apply_model`` walks the repeats in a
Python loop where the reference scans. The same call serves training
(cache=None, full causal), chunked prefill (cache + pos offset — Teola's
Partial/Full Prefilling) and decode (S == 1).

``block_tables`` switches the cache to the paged pool (serving/
kv_cache.py); ``verify=True`` marks a speculative verify chunk on it.

RWKV-6 layers (``models/ssm.py``) keep a per-sequence recurrent state in
the dense cache (``state``, ``sx_tm``, ``sx_cm``), updated in place; they
ignore ``pos``. Hybrid SSM, MLA (dense and paged) and MoE layers and
embedding inputs are not ported yet (ROADMAP.md Queue 1, item 10).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import (act_fn, dense_init, embed_init,
                                       rms_norm, softcap, tree_map)


def _supported(cfg: ModelConfig, spec: LayerSpec) -> bool:
    if spec.moe or cfg.embed_stub:
        return False
    if spec.kind == "rwkv":
        return cfg.ssm is not None and cfg.ssm.kind == "rwkv6"
    return spec.kind == "attn" and cfg.attention_kind == "gqa"


def _check_supported(cfg: ModelConfig):
    for st in cfg.stages:
        for spec in st.pattern:
            if not _supported(cfg, spec):
                raise NotImplementedError(
                    f"{cfg.name}: only dense GQA and RWKV-6 decoders with "
                    f"token inputs are ported (ROADMAP.md Queue 1, item 10)")


# ---------------------------------------------------------------------------
# init

def init_layer_elem(generator, cfg: ModelConfig, spec: LayerSpec, dtype,
                    device, repeat: int):
    d, f = cfg.d_model, cfg.d_ff
    zeros = lambda: torch.zeros((repeat, d), dtype=dtype, device=device)  # noqa: E731
    if spec.kind == "rwkv":
        return {"ln1": zeros(), "ln2": zeros(),
                **ssm.init_rwkv_params(generator, cfg, dtype, device, repeat)}
    return {
        "ln1": zeros(), "ln2": zeros(),
        "attn": attn.init_gqa_params(generator, cfg, dtype, device, repeat),
        "mlp": {
            "w_gate": dense_init(generator, (repeat, d, f), dtype, device,
                                 fan_in=d),
            "w_up": dense_init(generator, (repeat, d, f), dtype, device,
                               fan_in=d),
            "w_down": dense_init(generator, (repeat, f, d), dtype, device,
                                 fan_in=f),
        },
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda"):
    """Random weights with the reference ``init_params``'s shapes and
    scales, drawn from ``generator`` on the generator's device and placed
    on ``device``."""
    _check_supported(cfg)
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


def apply_layer(cfg, spec, p, x, ce, pos, block_tables=None, verify=False):
    """One transformer layer. ce: cache elem dict or None (paged pool
    elems when ``block_tables`` is given). Returns (x, new_cache_elem)."""
    if spec.kind == "rwkv":
        return _rwkv_layer(cfg, p, x, ce)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a_out, nc = attn.gqa_layer(cfg, spec, p["attn"], h, ce, pos,
                               block_tables, verify)
    x = x + a_out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _ffn(cfg, p["mlp"], h)
    return x, nc


def apply_model(cfg: ModelConfig, params, inputs, cache=None, pos=0, *,
                logits_slice=None, logits_at=None, block_tables=None,
                verify=False):
    """inputs: int tokens (B,S). Returns (logits, cache).

    cache/pos implement chunked (partial) prefill and decode (the cache is
    updated in place and returned); cache=None is training/eval over the
    full sequence. ``block_tables`` (B,maxblk) switches the cache to the
    PAGED layout (shared block pools indexed per sequence); ``verify``
    routes a paged chunk through the speculative verify kernel.
    ``logits_at`` (B,) computes the head only at one per-sequence chunk
    index (exact last-token logits under right-padded bucketed prefill),
    returning (B,1,vocab)."""
    _check_supported(cfg)
    x = params["embed"][inputs.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=x.device, dtype=torch.int32)
    if block_tables is not None:
        block_tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                       device=x.device)

    for si, st in enumerate(cfg.stages):
        elems = params["stages"][si]
        cache_st = cache["stages"][si] if cache is not None else None
        for r in range(st.repeat):
            for ei, spec in enumerate(st.pattern):
                ce = None if cache_st is None else \
                    tree_map(lambda t: t[r], cache_st[ei])
                pe = tree_map(lambda t: t[r], elems[ei])
                x, _ = apply_layer(cfg, spec, pe, x, ce, pos,
                                   block_tables, verify)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_at is not None:
        logits_at = torch.as_tensor(logits_at, device=x.device).long()
        x = x[torch.arange(x.shape[0], device=x.device), logits_at][:, None]
    elif logits_slice is not None:
        x = x[:, -logits_slice:, :]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    logits = softcap(logits, cfg.final_logit_softcap)
    return logits, cache
