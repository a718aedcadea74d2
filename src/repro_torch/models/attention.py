"""GQA attention with position-mask handling of train / chunked-prefill /
decode and linear / ring-buffer caches (PyTorch counterpart of the GQA
half of ``repro/models/attention.py``).

The mask is derived purely from absolute positions:
    valid(i, j) = k_pos[j] >= 0  and  k_pos[j] <= q_pos[i]
                  and (window is None or k_pos[j] > q_pos[i] - window)

The dense linear-cache branch (full-attention layers with a cache) goes
through the two ported kernels: ``flash_prefill`` for a chunk (S > 1,
Teola's Partial/Full Prefilling against the resident prefix) and
``decode_attention`` for one token (S == 1). Their masks are exactly the
position mask above over a linear cache (slot j valid iff j < pos+S).

The paged branch (``block_tables`` given; cache elems are shared block
pools) writes through the tables in place and reads through three more
kernels, which compute exactly the reference's gathered, masked
attention: ``paged_decode_attention`` for one token, ``verify_attention``
for a speculative verify chunk (``verify=True``), and
``chunk_prefill_attention`` for every other chunk (monolithic paged
prefill and each chunked-prefill chunk). The layer cannot tell a verify
chunk from a prefill chunk by its shape, hence the keyword. Windowed
layers page linearly, with the window in the mask.

On CUDA tensors the kernel wrappers launch the hand-written kernels; on
CPU tensors they run their plain PyTorch versions. Windowed (ring-buffer)
dense layers and the no-cache training call use the plain masked
attention on every device.

MLA (DeepSeek-V3's multi-head latent attention, ``mla_layer``) runs in
the absorbed form with its compressed cache (``ckv``, ``krope``) dense or
paged. Its attention core is plain PyTorch on every device: the reference
computes it with XLA einsums and has no Pallas kernel for it, so there is
no kernel to port and none is bypassed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.chunk_prefill import chunk_prefill_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_gather,
                                                 verify_attention)
from repro_torch.models.common import (apply_rope, dense_init, rms_norm,
                                       softcap)
from repro_torch.serving import kv_cache as kvc

NEG_INF = -2.0e38


def position_mask(q_pos, k_pos, window):
    """q_pos (B,Sq), k_pos (B,Skv) -> (B,Sq,Skv)."""
    kp = k_pos[:, None, :]
    qp = q_pos[:, :, None]
    m = (kp >= 0) & (kp <= qp)
    if window is not None:
        m &= kp > (qp - window)
    return m


def _gqa_core(q, k, v, q_pos, k_pos, scale, window, cap):
    """q (B,Sq,H,hd); k,v (B,Skv,K,hd); grouped einsum (no KV repeat).
    Plain masked attention: the reference's ``gqa_attention`` without its
    memory-bounding loop over query blocks."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qh = q.reshape(B, Sq, K, G, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qh, k.float()) * scale
    s = softcap(s, cap)
    mask = position_mask(q_pos, k_pos, window)              # (B,Sq,Skv)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA layer (projections + cache handling)

def init_gqa_params(generator, cfg, dtype, device, repeat: int):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads

    def w(shape):
        return dense_init(generator, (repeat, *shape), dtype, device,
                          fan_in=shape[0])

    p = {"wq": w((d, H * hd)), "wk": w((d, K * hd)), "wv": w((d, K * hd)),
         "wo": w((H * hd, d))}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((repeat, n), dtype=dtype, device=device)
    return p


def paged_write(pool, chunk, block_tables, positions):
    """Scatter a (B,S,...) chunk into a (nb,bs,...) pool through per-seq
    block tables, in place: token (b,i) at absolute position p =
    positions[b,i] lands in physical block block_tables[b, p // bs] at
    offset p % bs. Distinct sequences own distinct blocks, so batch
    scatters never collide (padding rows all target the reserved pad
    block — scratch data, never read by a real row).

    A position past the table's width is DROPPED, as in the reference
    (its ``take_along_axis`` yields an out-of-range block id there and the
    scatter discards the write): here such writes land on the scratch pad
    block. A frozen member of a run-to-completion decode batch makes them
    (``LLMEngine._paged_decode_batch``); clamping them into the last table
    block instead would overwrite a live slot."""
    bs = pool.shape[1]
    maxblk = block_tables.shape[1]
    lb = (positions // bs).long()
    bid = torch.gather(block_tables.long(), 1, lb.clamp(max=maxblk - 1))
    bid = torch.where(lb < maxblk, bid, kvc.PAD_BLOCK)
    pool[bid, (positions % bs).long()] = chunk.to(pool.dtype)
    return pool


def gqa_layer(cfg, spec, p, x, cache, pos, block_tables=None,
              verify=False):
    """x (B,S,d). cache: elem dict {'k','v'} of (B,T,K,hd) or None
    (train). pos: int or (B,) tensor (tokens already in cache; 0 for
    train). With ``block_tables`` (B,maxblk), cache elems are PAGED POOLS
    (nb,bs,K,hd) shared across sequences; ``verify`` marks a speculative
    verify chunk. Cache writes happen in place. Returns (out, new_cache)."""
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)

    pos = kvc.batch_pos(pos, B, x.device)
    positions = pos[:, None] + torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_kind)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_kind)
    cap = cfg.attn_logit_softcap

    if cache is None:
        o = _gqa_core(q, k, v, positions, positions, scale, spec.window,
                      cap)
        new_cache = None
    elif block_tables is not None:
        kp = paged_write(cache["k"], k, block_tables, positions)
        vp = paged_write(cache["v"], v, block_tables, positions)
        kw = dict(window=spec.window, cap=cap, scale=scale)
        if S == 1:
            o = paged_decode_attention(q[:, 0], kp, vp, block_tables,
                                       pos + 1, **kw)[:, None]
        elif verify:
            o = verify_attention(q, kp, vp, block_tables, pos + S, **kw)
        else:
            o = chunk_prefill_attention(q, kp, vp, block_tables, pos, **kw)
        new_cache = {"k": kp, "v": vp}
    else:
        kb, vb = cache["k"], cache["v"]
        T = kb.shape[1]
        if spec.window is not None:
            # ring buffer (degenerates to linear while pos+S <= T); the
            # window itself is enforced by the position mask
            kb = kvc.write_ring(kb, k, pos)
            vb = kvc.write_ring(vb, v, pos)
            k_pos = kvc.slot_positions_ring(T, pos + S)
            o = _gqa_core(q, kb.to(x.dtype), vb.to(x.dtype), positions,
                          k_pos, scale, spec.window, cap)
        else:
            kb = kvc.write_linear(kb, k, pos)
            vb = kvc.write_linear(vb, v, pos)
            if S == 1:
                o = decode_attention(q[:, 0], kb, vb, pos + 1, cap=cap,
                                     scale=scale)[:, None]
            else:
                o = flash_prefill(q, kb, vb, prefix_len=pos,
                                  total_len=pos + S, cap=cap, scale=scale)
        new_cache = {"k": kb, "v": vb}
    out = o.reshape(B, S, H * hd) @ p["wo"]
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): absorbed formulation throughout.
#
# Scores are computed in the compressed kv_lora space, so per-head K/V are
# never expanded over the context:
#   q_eff = q_nope @ W_kv_b[k-part]      (B,S,H,r)
#   s     = q_eff . ckv + q_rope . k_rope
#   ctx   = softmax(s) . ckv             (B,S,H,r)
#   out_h = ctx @ W_kv_b[v-part]

def init_mla_params(generator, cfg, dtype, device, repeat: int):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim

    def w(shape):
        return dense_init(generator, (repeat, *shape), dtype, device,
                          fan_in=shape[0])

    def zeros(n):
        return torch.zeros((repeat, n), dtype=dtype, device=device)

    return {
        "wq_a": w((d, m.q_lora_rank)),
        "q_norm": zeros(m.q_lora_rank),
        "wq_b": w((m.q_lora_rank, H * qk_hd)),
        "wkv_a": w((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": zeros(m.kv_lora_rank),
        "wkv_b": w((m.kv_lora_rank,
                    H * (m.qk_nope_head_dim + m.v_head_dim))),
        "wo": w((H * m.v_head_dim, d)),
    }


def _mla_core(q_eff, q_rope, ckv, krope, q_pos, k_pos, scale, window):
    """q_eff (B,Sq,H,r); q_rope (B,Sq,H,p); ckv (B,T,r); krope (B,T,p)."""
    s = (torch.einsum("bshr,btr->bhst", q_eff.float(), ckv.float())
         + torch.einsum("bshp,btp->bhst", q_rope.float(), krope.float())) \
        * scale
    mask = position_mask(q_pos, k_pos, window)              # (B,Sq,Skv)
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", p, ckv.float())
    return ctx.to(q_eff.dtype)


def mla_layer(cfg, spec, p, x, cache, pos, block_tables=None):
    """x (B,S,d). cache: {'ckv' (B,T,r), 'krope' (B,T,p)} or None, or the
    paged pools {'ckv' (nb,bs,r), 'krope' (nb,bs,p)} with
    ``block_tables``. Cache writes happen in place. Returns (out,
    new_cache)."""
    m = cfg.mla
    B, S, d = x.shape
    H = cfg.num_heads
    nope = m.qk_nope_head_dim
    scale = (nope + m.qk_rope_head_dim) ** -0.5

    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(B, S, H, nope + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    pos = kvc.batch_pos(pos, B, x.device)
    positions = pos[:, None] + torch.arange(S, device=x.device)[None, :]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta, "neox")

    kv_a = x @ p["wkv_a"]
    ckv_new = rms_norm(kv_a[..., :m.kv_lora_rank], p["kv_norm"],
                       cfg.norm_eps)
    krope_new = apply_rope(kv_a[..., m.kv_lora_rank:], positions,
                           cfg.rope_theta, "neox")

    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, H, nope + m.v_head_dim)
    wk = wkv_b[..., :nope]                        # (r, H, nope)
    wv = wkv_b[..., nope:]                        # (r, H, v)
    q_eff = torch.einsum("bshn,rhn->bshr", q_nope, wk)

    if cache is None:
        ckv, krope, k_pos = ckv_new, krope_new, positions
        new_cache = None
    elif block_tables is not None:
        cp = paged_write(cache["ckv"], ckv_new, block_tables, positions)
        kp = paged_write(cache["krope"], krope_new, block_tables, positions)
        new_cache = {"ckv": cp, "krope": kp}
        ckv = paged_gather(cp, block_tables).to(x.dtype)
        krope = paged_gather(kp, block_tables).to(x.dtype)
        k_pos = kvc.slot_positions_linear(ckv.shape[1], pos + S)
    else:
        cb = kvc.write_linear(cache["ckv"], ckv_new, pos)
        kb = kvc.write_linear(cache["krope"], krope_new, pos)
        new_cache = {"ckv": cb, "krope": kb}
        ckv, krope = cb.to(x.dtype), kb.to(x.dtype)
        k_pos = kvc.slot_positions_linear(ckv.shape[1], pos + S)

    ctx = _mla_core(q_eff, q_rope, ckv, krope, positions, k_pos, scale,
                    spec.window)
    out_h = torch.einsum("bshr,rhv->bshv", ctx, wv)
    out = out_h.reshape(B, S, H * m.v_head_dim) @ p["wo"]
    return out, new_cache
