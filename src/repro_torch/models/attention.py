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
attention on every device, over blocks of ``q_block`` queries as the
reference's ``blockwise_over_q`` (``gqa_attention``; ``causal_skip``
skips the blocks above the diagonal); under autograd a block's scores
are recomputed in the backward, not kept.

On a rank's slice of a sequence-split dense cache (``attend_slice``,
``mla_attend_slice``) the attention returns each row's log-sum-exp with
its output, for ``models/sharding.py::merge_partials``.

MLA (DeepSeek-V3's multi-head latent attention, ``mla_layer``) runs in
the absorbed form with its compressed cache (``ckv``, ``krope``) dense or
paged. Its attention core is plain PyTorch on every device: the reference
computes it with XLA einsums and has no Pallas kernel for it, so there is
no kernel to port and none is bypassed.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.chunk_prefill import chunk_prefill_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_prefill import flash_prefill, masked_lse
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_gather,
                                                 verify_attention)
from repro_torch.launch import optflags
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


def _gqa_probs(q, k, q_pos, k_pos, scale, window, cap):
    """q (B,Sq,H,hd); k (B,Skv,K,hd); grouped einsum (no KV repeat).
    Returns the softmax p (B,K,G,Sq,Skv) float32 of the masked scores s,
    s itself, the mask (B,Sq,Skv) and the scaled scores before the
    softcap."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qh = q.reshape(B, Sq, K, H // K, hd).float()
    raw = torch.einsum("bskgh,btkh->bkgst", qh, k.float()) * scale
    mask = position_mask(q_pos, k_pos, window)              # (B,Sq,Skv)
    s = torch.where(mask[:, None, None], softcap(raw, cap), NEG_INF)
    return torch.softmax(s, dim=-1), s, mask, raw


def _gqa_core(q, k, v, q_pos, k_pos, scale, window, cap, return_lse=False):
    """q (B,Sq,H,hd); k,v (B,Skv,K,hd). Plain masked attention over one
    block of queries. With ``return_lse`` also each row's log-sum-exp
    (B,Sq,H) float32, a row that sees no key giving o = 0 and lse = -inf
    (``kernels.flash_prefill.masked_lse``)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    p, s, mask, _ = _gqa_probs(q, k, q_pos, k_pos, scale, window, cap)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    o = o.reshape(B, Sq, H, hd)
    if not return_lse:
        return o.to(q.dtype)
    return masked_lse(o, s, mask[:, None, None].any(-1).expand(
        B, K, H // K, Sq), q.dtype)


def _rows(x, K):
    """(B,S,H,hd) -> (B*K, S*G, hd) float32, contiguous: the query rows of
    each (sequence, kv head), row s*G + g for position s and head g of the
    group, so that a block of positions is a contiguous run of rows."""
    B, S, H, hd = x.shape
    return x.reshape(B, S, K, H // K, hd).transpose(1, 2).float() \
        .reshape(B * K, S * (H // K), hd)


def _block_probs(qT, kT, mask, blk, G, scale, cap):
    """One block's probabilities (B*K, n*G, m) float32: queries [a, b)
    against keys [c, d), blk = (a, b, c, d); qT (B*K, S*G, hd), kT (B*K,
    T, hd), mask (B,S,T). Also its scaled scores before the softcap."""
    a, b, c, d = blk
    n, m = b - a, d - c
    BK = qT.shape[0]
    B = mask.shape[0]
    raw = torch.baddbmm(qT.new_empty(()).expand(BK, n * G, m),
                        qT[:, a * G:b * G], kT[:, c:d].transpose(-1, -2),
                        beta=0, alpha=scale)
    s = torch.where(mask[:, None, a:b, None, c:d],
                    softcap(raw, cap).view(B, BK // B, n, G, m), NEG_INF)
    return torch.softmax(s, dim=-1).view(BK, n * G, m), raw


class _BlockedGQA(torch.autograd.Function):
    """Masked GQA attention over query blocks under autograd. Each block's
    probabilities are recomputed in the backward, as the reference's
    checkpointed blocks recompute theirs, and the attention gradient is
    applied directly: dV = P^T dO; dS = P (dP - D) with dP = dO V^T and D
    = rowsum(dO O), 0 at masked keys, through the softcap's 1 - tanh^2;
    dQ = scale dS K, dK = scale dS^T Q. Autograd keeps q, k, v, the mask
    and the float32 output, and records no per-block graph: each block
    under ``torch.utils.checkpoint`` kept the same bytes but took the
    whole TinyLlama-1.1B train step from 0.80 to 1.20-1.35 s at blocks of
    64 on one H100 (352 blocks a step; ``chip_smoke.py --timing``,
    PERF.md), its host work per block outrunning the card's. A block is
    one batched product per matrix over every (sequence, kv head), its G
    heads' rows together (``_rows``), written into its slice of the
    result in place. ``blocks``: (q_lo, q_hi, kv_lo, kv_hi) per block."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, blocks, scale, window, cap):
        B, S, H, hd = q.shape
        K = k.shape[2]
        G = H // K
        mask = position_mask(q_pos, k_pos, window)          # (B,S,T)
        qT, kT, vT = _rows(q, K), _rows(k, K), _rows(v, K)
        out = torch.empty_like(qT)
        for blk in blocks:
            a, b, c, d = blk
            p, _ = _block_probs(qT, kT, mask, blk, G, scale, cap)
            out[:, a * G:b * G].baddbmm_(p, vT[:, c:d], beta=0)
        ctx.save_for_backward(q, k, v, mask, out)
        ctx.args = (blocks, scale, cap)
        return out.view(B, K, S, G, hd).transpose(1, 2).reshape(
            B, S, H, hd).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out = ctx.saved_tensors
        blocks, scale, cap = ctx.args
        B, S, H, hd = q.shape
        K = k.shape[2]
        G = H // K
        qT, kT, vT, doT = (_rows(t, K) for t in (q, k, v, do))
        D = (doT * out).sum(-1, keepdim=True)               # (B*K,S*G,1)
        dqT = torch.empty_like(qT)
        dkT, dvT = torch.zeros_like(kT), torch.zeros_like(vT)
        for blk in blocks:
            a, b, c, d = blk
            r = slice(a * G, b * G)
            p, raw = _block_probs(qT, kT, mask, blk, G, scale, cap)
            dvT[:, c:d].baddbmm_(p.transpose(-1, -2), doT[:, r])
            ds = p * (torch.bmm(doT[:, r], vT[:, c:d].transpose(-1, -2))
                      - D[:, r])
            ds = torch.where(mask[:, None, a:b, None, c:d],
                             ds.view(B, K, b - a, G, d - c), 0.0)
            if cap is not None:
                ds = ds * (1 - torch.square(torch.tanh(raw / cap))).view(
                    ds.shape)
            ds = ds.view(B * K, (b - a) * G, d - c)
            dqT[:, r].baddbmm_(ds, kT[:, c:d], beta=0, alpha=scale)
            dkT[:, c:d].baddbmm_(ds.transpose(-1, -2), qT[:, r],
                                 alpha=scale)
        return (dqT.view(B, K, S, G, hd).transpose(1, 2).reshape(
                    B, S, H, hd).to(q.dtype),
                dkT.view(B, K, -1, hd).transpose(1, 2).to(k.dtype),
                dvT.view(B, K, -1, hd).transpose(1, 2).to(v.dtype),
                None, None, None, None, None, None)


def _gqa_blocked(q, k, v, q_pos, k_pos, blocks, scale, window, cap,
                 return_lse=False):
    """``_gqa_core`` over ``blocks`` ((q_lo, q_hi, kv_lo, kv_hi) each): one
    block's scores at a time, through ``_BlockedGQA`` under autograd."""
    if torch.is_grad_enabled() and not return_lse and \
            any(t.requires_grad for t in (q, k, v)):
        return _BlockedGQA.apply(q, k, v, q_pos, k_pos, blocks, scale,
                                 window, cap)
    outs = [_gqa_core(q[:, a:b], k[:, c:d], v[:, c:d], q_pos[:, a:b],
                      k_pos[:, c:d], scale, window, cap, return_lse)
            for a, b, c, d in blocks]
    if return_lse:
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return torch.cat(outs, dim=1)


def _block(core, *args):
    """``core(*args)``, checkpointed under autograd: the backward
    recomputes the block's scores instead of keeping them."""
    if not torch.is_grad_enabled():
        return core(*args)
    return checkpoint(core, *args, use_reentrant=False,
                      preserve_rng_state=False)


def blockwise_over_q(core, q, q_pos, q_block):
    """Run ``core(q_blk, q_pos_blk)`` over query blocks, each block
    checkpointed, keeping peak memory at one block of scores (the
    reference's ``lax.map`` over ``jax.checkpoint``-ed blocks). One call
    when Sq <= q_block or q_block does not divide Sq, as in the reference.
    q: (B,Sq,...), or a tuple of such tensors cut together (MLA's q_eff
    and q_rope); q_pos: (B,Sq). ``core`` returns a tensor or a tuple of
    tensors, each with the query axis at dim 1. (GQA's own blocks go
    through ``_gqa_blocked``, whose backward needs no checkpoint.)"""
    Sq = q_pos.shape[1]
    if Sq <= q_block or Sq % q_block != 0:
        return core(q, q_pos)

    def cut(t, i):
        return tuple(x[:, i:i + q_block] for x in t) \
            if isinstance(t, tuple) else t[:, i:i + q_block]
    outs = [_block(core, cut(q, i), cut(q_pos, i))
            for i in range(0, Sq, q_block)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return torch.cat(outs, dim=1)


def gqa_attention(q, k, v, q_pos, k_pos, *, scale, window=None, cap=None,
                  q_block=512, causal_skip=False, return_lse=False):
    """Masked GQA attention over blocks of ``q_block`` queries, one call
    when Sq <= q_block or q_block does not divide Sq (the reference's
    ``blockwise_over_q``), or, with ``causal_skip``, with the blocks above
    the diagonal skipped (``_gqa_causal_skip``)."""
    if causal_skip:
        return _gqa_causal_skip(q, k, v, q_pos, k_pos, scale, window, cap,
                                q_block)
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq <= q_block or Sq % q_block != 0:
        return _gqa_core(q, k, v, q_pos, k_pos, scale, window, cap,
                         return_lse)
    return _gqa_blocked(q, k, v, q_pos, k_pos,
                        [(i, i + q_block, 0, Skv)
                         for i in range(0, Sq, q_block)],
                        scale, window, cap, return_lse)


def _gqa_causal_skip(q, k, v, q_pos, k_pos, scale, window, cap, q_block):
    """Causal block skipping (optflag 'causal_skip'): block i attends only
    KV[lo : (i+1)*q_block], lo the window's clip rounded down to a block,
    which halves the attention FLOPs of full causal self-attention.
    Requires q_pos == k_pos == contiguous (training / full prefill), as in
    the reference."""
    Sq = q.shape[1]
    if Sq <= q_block or Sq % q_block != 0:
        return _gqa_core(q, k, v, q_pos, k_pos, scale, window, cap)
    blocks = []
    for i in range(Sq // q_block):
        hi = (i + 1) * q_block
        lo = 0
        if window is not None:            # also clip from the left
            lo = max(0, (i * q_block - window) // q_block * q_block)
        blocks.append((i * q_block, hi, lo, hi))
    return _gqa_blocked(q, k, v, q_pos, k_pos, blocks, scale, window, cap)


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


def gqa_scale(cfg):
    hd = cfg.resolved_head_dim
    return cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5


def gqa_qkv(cfg, p, x, pos, proj=None):
    """The roped q (B,S,H,hd) and k, v (B,S,K,hd) of x (B,S,d), with the
    per-sequence pos (B,) and positions (B,S). ``proj(name, bias)`` gives
    one projection's output (default: x @ p[name] + p[bias]); the sharded
    path passes one that all-gathers a column-parallel projection."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    if proj is None:
        def proj(name, bias):
            y = x @ p[name]
            return y + p[bias] if cfg.qkv_bias else y
    q = proj("wq", "bq").reshape(B, S, cfg.num_heads, hd)
    k = proj("wk", "bk").reshape(B, S, cfg.num_kv_heads, hd)
    v = proj("wv", "bv").reshape(B, S, cfg.num_kv_heads, hd)
    pos = kvc.batch_pos(pos, B, x.device)
    positions = pos[:, None] + torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_kind)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_kind)
    return q, k, v, pos, positions


def attend_slice(q, k, v, cache, pos, positions, seq, *, window, cap, scale,
                 q_block=512):
    """The S new tokens' attention over a rank's slice of a sequence-split
    dense cache (``launch/shard_rules.py::cache_spec``): q (B,S,H,hd) and
    k, v (B,S,K,hd) of every head; cache {'k', 'v'} (B,T,K,hd), global
    slots [first, first+T) of ``total``, ``seq = (first, total)``. k and v
    go into the slots the slice owns (``kv_cache.write_linear`` /
    ``write_ring``), then (o, lse) over the slice's keys alone: through K1
    (S > 1) or K2 (S == 1) with ``return_lse``, a windowed ring through
    the plain masked attention. The local prefix pos - first may be
    negative and the local length 0: rows that see none of the slice's
    keys give o = 0, lse = -inf. ``pos``: an int or (B,) tensor as the
    layer got it (the slot arithmetic of the writes runs on the host).
    Returns o (B,S,H,hd), lse (B,S,H)."""
    first, total = seq
    kb, vb = cache["k"], cache["v"]
    T, S = kb.shape[1], q.shape[1]
    host_pos, pos = pos, kvc.batch_pos(pos, q.shape[0], q.device)
    if window is not None:
        kvc.write_ring(kb, k, host_pos, seq)
        kvc.write_ring(vb, v, host_pos, seq)
        k_pos = kvc.slot_positions_ring(total, pos + S)[:, first:first + T]
        return gqa_attention(q, kb.to(q.dtype), vb.to(q.dtype), positions,
                             k_pos, scale=scale, window=window, cap=cap,
                             q_block=q_block, return_lse=True)
    kvc.write_linear(kb, k, host_pos, seq)
    kvc.write_linear(vb, v, host_pos, seq)
    if S == 1:
        o, lse = decode_attention(q[:, 0], kb, vb,
                                  torch.clamp(pos + 1 - first, 0, T),
                                  cap=cap, scale=scale, return_lse=True)
        return o[:, None], lse[:, None]
    return flash_prefill(q, kb, vb, prefix_len=pos - first,
                         total_len=pos + S - first, cap=cap, scale=scale,
                         return_lse=True)


def gqa_layer(cfg, spec, p, x, cache, pos, block_tables=None,
              verify=False, q_block=512):
    """x (B,S,d). cache: elem dict {'k','v'} of (B,T,K,hd) or None
    (train). pos: int or (B,) tensor (tokens already in cache; 0 for
    train). With ``block_tables`` (B,maxblk), cache elems are PAGED POOLS
    (nb,bs,K,hd) shared across sequences; ``verify`` marks a speculative
    verify chunk. ``q_block``: the query-block size of the plain masked
    attention (the no-cache and ring-buffer calls). Cache writes happen
    in place. Returns (out, new_cache)."""
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    H = cfg.num_heads
    scale = gqa_scale(cfg)
    q, k, v, pos, positions = gqa_qkv(cfg, p, x, pos)
    cap = cfg.attn_logit_softcap

    if cache is None:
        o = gqa_attention(q, k, v, positions, positions, scale=scale,
                          window=spec.window, cap=cap, q_block=q_block,
                          causal_skip=optflags.has("causal_skip"))
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
            o = gqa_attention(q, kb.to(x.dtype), vb.to(x.dtype), positions,
                              k_pos, scale=scale, window=spec.window,
                              cap=cap, q_block=q_block)
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


def _mla_core(q_eff, q_rope, ckv, krope, q_pos, k_pos, scale, window,
              return_lse=False):
    """q_eff (B,Sq,H,r); q_rope (B,Sq,H,p); ckv (B,T,r); krope (B,T,p).
    With ``return_lse`` also each row's log-sum-exp (B,Sq,H), as
    ``_gqa_core``."""
    s = (torch.einsum("bshr,btr->bhst", q_eff.float(), ckv.float())
         + torch.einsum("bshp,btp->bhst", q_rope.float(), krope.float())) \
        * scale
    mask = position_mask(q_pos, k_pos, window)              # (B,Sq,Skv)
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", p, ckv.float())
    if not return_lse:
        return ctx.to(q_eff.dtype)
    B, Sq, H = q_eff.shape[:3]
    # masked_lse's (B, K, G, Sq, T) with K = 1 group of all H heads
    return masked_lse(ctx, s[:, None], mask[:, None, None].any(-1).expand(
        B, 1, H, Sq), q_eff.dtype)


def mla_attention(q_eff, q_rope, ckv, krope, q_pos, k_pos, *, scale,
                  window=None, q_block=512, return_lse=False):
    """``_mla_core`` blockwise over queries (the pair q_eff, q_rope)."""
    return blockwise_over_q(
        lambda qq, pp: _mla_core(*qq, ckv, krope, pp, k_pos, scale, window,
                                 return_lse), (q_eff, q_rope), q_pos,
        q_block)


def mla_project(cfg, p, x, pos, cq):
    """MLA's absorbed projections from x (B,S,d) and cq (B,S,q_lora), the
    normed q_a output: (q_eff (B,S,H,r), q_rope (B,S,H,p), ckv_new
    (B,S,r), krope_new (B,S,p), wv (r,H,v), pos (B,), positions (B,S)).
    H is the head count of ``wq_b`` / ``wkv_b`` as given: one rank's
    heads on the sharded path."""
    m = cfg.mla
    B, S, _ = x.shape
    nope = m.qk_nope_head_dim
    q = (cq @ p["wq_b"]).reshape(B, S, -1, nope + m.qk_rope_head_dim)
    H = q.shape[2]
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
    q_eff = torch.einsum("bshn,rhn->bshr", q_nope, wkv_b[..., :nope])
    return q_eff, q_rope, ckv_new, krope_new, wkv_b[..., nope:], pos, \
        positions


def mla_scale(cfg):
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_attend_slice(q_eff, q_rope, ckv_new, krope_new, cache, pos,
                     positions, seq, *, scale, window, q_block=512):
    """``attend_slice`` for MLA's compressed cache {'ckv' (B,T,r), 'krope'
    (B,T,p)}: the new entries written into the slice's slots, then
    (ctx (B,S,H,r), lse (B,S,H)) over the slice's keys through the plain
    core. ``pos`` as the layer got it."""
    first, total = seq
    cb = kvc.write_linear(cache["ckv"], ckv_new, pos, seq)
    kb = kvc.write_linear(cache["krope"], krope_new, pos, seq)
    T, S = cb.shape[1], q_eff.shape[1]
    pos = kvc.batch_pos(pos, q_eff.shape[0], q_eff.device)
    k_pos = kvc.slot_positions_linear(total, pos + S)[:, first:first + T]
    return mla_attention(q_eff, q_rope, cb.to(q_eff.dtype),
                         kb.to(q_eff.dtype), positions, k_pos, scale=scale,
                         window=window, q_block=q_block, return_lse=True)


def mla_layer(cfg, spec, p, x, cache, pos, block_tables=None, q_block=512):
    """x (B,S,d). cache: {'ckv' (B,T,r), 'krope' (B,T,p)} or None, or the
    paged pools {'ckv' (nb,bs,r), 'krope' (nb,bs,p)} with
    ``block_tables``. The attention runs blockwise over ``q_block``
    queries on every path, as in the reference. Cache writes happen in
    place. Returns (out, new_cache)."""
    B, S, d = x.shape
    q_eff, q_rope, ckv_new, krope_new, wv, pos, positions = mla_project(
        cfg, p, x, pos, rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps))

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

    ctx = mla_attention(q_eff, q_rope, ckv, krope, positions, k_pos,
                        scale=mla_scale(cfg), window=spec.window,
                        q_block=q_block)
    out_h = torch.einsum("bshr,rhv->bshv", ctx, wv)
    return out_h.reshape(B, S, -1) @ p["wo"], new_cache
