"""Batched GQA decode attention over a dense KV cache (one new token per
sequence, dynamic per-sequence valid length).

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py::
decode_attention`` (``_kernel``, ``_flash_block``) with a split-KV
(flash-decoding) CUDA kernel written for Hopper,
``repro_torch/csrc/decode_attention.cu`` over ``csrc/split_kv.cuh``: a
split pass over chunks of ``CHUNK`` keys, then a combine pass, both from
one C call. Those files say what bounds it on the H100 (memory: about 2*G
flops per byte of K/V; at serve sizes, latency) and what the design does
about that.

``decode_attention`` launches the kernel for CUDA tensors and runs
``decode_attention_plain`` — the same function in plain PyTorch — for CPU
tensors. There is no fallback between the two: a CUDA call that cannot
launch raises. ``decode_attention.launches`` counts wrapper calls that
launched the kernels (one per call: split and combine together).

``split_kv_plain`` mirrors the kernels' partition and merge in plain
PyTorch (the same ``CHUNK``, the same rule for which chunks are live, the
same (m, l, acc) merge). Only the tests use it: it is the CPU evidence for
the combine algebra, which the CUDA kernel cannot show without a card.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill import masked_lse

NEG_INF = -2.0e38
MAX_GROUP = 16       # query heads per kv head the kernel holds
CHUNK = 64           # keys per split: SKV_CH in csrc/split_kv.cuh

_count_lock = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, length, ws, ws_floats, B, H, K, T, hd, q_dtype, kv_dtype,
# scale, window, cap, lse, stream
_ARGTYPES = [_P] * 6 + [ctypes.c_longlong] + [_I] * 7 + [_F, _I, _F, _P,
                                                          _P]


def split_workspace(B, K, span, rows, hd, device):
    """The per-call fp32 workspace of the split kernels (csrc/split_kv.cuh
    ``split_kv_workspace``): (B, K, ceil(span / CHUNK)) splits of
    rows x hd partial sums, then their (m, l) pairs. Allocated on every
    call from the caching allocator, never cached: engines launch from
    several host threads onto one stream, and a shared buffer would let
    one call's split pass overwrite another's partials before its combine
    ran. Stream-ordered, so it is also safe under CUDA-graph capture."""
    ns = -(-span // CHUNK)
    return torch.empty(B * K * ns * rows * (hd + 2), dtype=torch.float32,
                       device=device)


def decode_attention_plain(q, k, v, length, *, window=None, cap=None,
                           scale=None, return_lse=False):
    """q (B,H,hd); k,v (B,T,K,hd); length (B,) valid cache lengths (the
    new token's KV already written at length-1). Returns (B,H,hd) in q's
    dtype, or (o, lse (B,H) float32) with ``return_lse``."""
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = hd ** -0.5
    length = torch.as_tensor(length, device=q.device).long()
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgh,btkh->bkgt", qg, k.float()) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    k_pos = torch.arange(T, device=q.device)[None, :]            # (1,T)
    mask = k_pos < length[:, None]
    if window is not None:
        mask &= k_pos > (length[:, None] - 1 - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    if not return_lse:
        return o.reshape(B, H, hd).to(q.dtype)
    seen = mask.any(-1)[:, None, None].expand(B, K, G)
    o, lse = masked_lse(o.reshape(B, 1, H, hd), s[:, :, :, None], seen[
        ..., None], q.dtype)
    return o[:, 0], lse[:, 0]


def live_splits(length, Sq, span, window, chunk=CHUNK):
    """The splits of ``chunk`` keys that hold a key visible to some query
    row of a sequence of total length ``length`` whose last ``Sq``
    positions are the queries, as ``range(lo, hi)`` (the kernels' rule,
    ``visible_keys`` in csrc/split_kv.cuh)."""
    hi = min(length, span)
    lo = max(0, length - Sq - window + 1) if window else 0
    if lo >= hi:
        return range(0)
    return range(lo // chunk, -(-hi // chunk))


def split_kv_plain(q, k, v, length, *, window=None, cap=None, scale=None,
                   chunk=CHUNK):
    """The split kernels' algorithm in plain PyTorch (tests only). q
    (B,Sq,H,hd); k,v (B,T,K,hd) the linear view; length (B,) total valid
    length including the Sq query positions (query s sits at
    length - Sq + s). Each live split of ``chunk`` keys yields the max m,
    sum l and unnormalised acc of its rows, masked keys counting 0; the
    splits merge as m* = max m_i, o = sum e^(m_i-m*) acc_i /
    max(sum e^(m_i-m*) l_i, 1e-30). Returns (B,Sq,H,hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = hd ** -0.5
    lengths = [int(n) for n in torch.as_tensor(length).reshape(-1).expand(B)]
    out = torch.zeros(B, K, Sq * G, hd)
    # rows s*G + g of kv head kvh: chunk position s of head kvh*G + g
    rows = q.float().cpu().reshape(B, Sq, K, G, hd).transpose(1, 2).reshape(
        B, K, Sq * G, hd)
    kf, vf = k.float().cpu(), v.float().cpu()
    for b, n in enumerate(lengths):
        qpos = n - Sq + torch.arange(Sq).repeat_interleave(G)[:, None]
        parts = []
        for s in live_splits(n, Sq, T, window or 0, chunk):
            j = torch.arange(s * chunk, min((s + 1) * chunk, T))
            sc = torch.einsum("krh,ckh->krc", rows[b], kf[b, j]) * scale
            if cap is not None:
                sc = cap * torch.tanh(sc / cap)
            vis = j[None, :] <= qpos                          # (R, c)
            if window:
                vis &= j[None, :] > qpos - window
            sc = torch.where(vis, sc, NEG_INF)
            m = sc.amax(-1)                                   # (K, R)
            p = torch.where(vis, torch.exp(sc - m[..., None]), 0.0)
            parts.append((m, p.sum(-1),
                          torch.einsum("krc,ckh->krh", p, vf[b, j])))
        if not parts:
            continue
        m_star = torch.stack([m for m, _, _ in parts]).amax(0)
        l_sum = sum(torch.exp(m - m_star) * l for m, l, _ in parts)
        acc = sum(torch.exp(m - m_star)[..., None] * a for m, _, a in parts)
        out[b] = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    o = out.reshape(B, K, Sq, G, hd).transpose(1, 2).reshape(B, Sq, H, hd)
    return o.to(q.device, q.dtype)


def decode_attention(q, k, v, length, *, window=None, cap=None, scale=None,
                     return_lse=False):
    """q (B,H,hd) float32|bfloat16; k,v (B,T,K,hd) bfloat16|float32;
    length (B,) int. Returns (B,H,hd) in q's dtype, or (o, lse) with
    ``return_lse``."""
    if build.plain_device(q):
        return decode_attention_plain(q, k, v, length, window=window,
                                      cap=cap, scale=scale,
                                      return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape != (B, T, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in build.HEAD_DIMS or H // K > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {hd}, group {H // K};"
                         f" the kernel takes head dims {build.HEAD_DIMS} "
                         f"and groups up to {MAX_GROUP}")
    if k.dtype != v.dtype or not (k.device == v.device == q.device):
        raise ValueError("decode_attention: k/v dtype or device mismatch")
    if scale is None:
        scale = hd ** -0.5
    length = torch.broadcast_to(
        torch.as_tensor(length, dtype=torch.int32, device=q.device),
        (B,)).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    ws = split_workspace(B, K, T, H // K, hd, q.device)
    launch = build.load("decode_attention", "decode_attention_launch",
                        _ARGTYPES)
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        length.data_ptr(), ws.data_ptr(), ws.numel(), B, H, K, T, hd,
        build.dtype_code(q), build.dtype_code(k), float(scale),
        int(window or 0), float(cap or 0.0),
        None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("decode_attention", err, "decode_attention")
    with _count_lock:       # engines launch from several threads
        decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
