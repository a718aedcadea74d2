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

MLA and MoE are not ported yet (ROADMAP.md Queue 1, item 10).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.chunk_prefill import chunk_prefill_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 verify_attention)
from repro_torch.models.common import apply_rope, dense_init, softcap
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
