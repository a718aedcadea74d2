"""Chunked-prefill flash attention against a resident KV prefix (Teola's
Partial/Full Prefilling, paper §4.2 Pass 3).

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_prefill.py::
flash_prefill`` (``_kernel``) with a CUDA kernel written for Hopper,
``repro_torch/csrc/flash_prefill.cu`` over the tile core
``csrc/flash_tile.cuh``: GQA-packed 128-row tiles (64 rows at head dim
256), bf16 K/V staged by cp.async, both products on the tensor cores (wgmma) with an fp32 q and the
fp32 probabilities split into three bf16 pieces each. Those files say what
bounds it on the H100 and how the design follows from that.

``flash_prefill`` launches the kernel for CUDA tensors and runs
``flash_prefill_plain`` — the same function in plain PyTorch — for CPU
tensors. There is no fallback between the two: a CUDA call that cannot
launch raises. ``flash_prefill.launches`` counts kernel launches.

``flash_prefill_split_plain`` mirrors the kernel's arithmetic in plain
PyTorch (the bf16 pieces of q and P, the 64-key tile walk, the online
softmax). Only the tests use it: it is the CPU evidence that three pieces
keep fp32's accuracy where one does not.

Unlike the reference, ``prefix_len`` (and ``total_len``) may be a (B,)
tensor: the serving engine batches sequences at different positions.

``return_lse=True`` also returns each query row's log-sum-exp of its
scores (after scale and softcap; (B, Sq, H) float32, natural log), which
the reference's Pallas kernel keeps internally as its running max and
sum: a rank that holds a slice of a sequence-split cache attends over its
slots and the ranks' partials merge by their LSEs
(``models/sharding.py::merge_partials``). On such a slice ``prefix_len``
is the chunk's position minus the slice's first slot and may be
negative, and rows can see no key at all: with ``return_lse`` such a row
gives o = 0 and lse = -inf (never NaN); without it nothing changes.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e38
TILE = 64            # keys per K/V tile: BK in csrc/flash_tile.cuh

_count_lock = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, prefix, total, B, Sq, H, K, T, hd, q_dtype, kv_dtype, scale,
# window, cap, lse, stream
_ARGTYPES = [_P] * 6 + [_I] * 8 + [_F, _I, _F, _P, _P]


def _per_seq(x, B, device):
    """int | (B,) tensor -> (B,) int32 tensor on ``device``."""
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    return torch.broadcast_to(t, (B,)).contiguous()


def _positions(B, Sq, T, prefix_len, total_len, window, device):
    """(B,Sq,T) mask of the keys each query sees."""
    prefix = _per_seq(prefix_len, B, device).long()
    total = prefix + Sq if total_len is None else \
        _per_seq(total_len, B, device).long()
    qp = (prefix[:, None] + torch.arange(Sq, device=device)[None, :])[
        :, :, None]                                          # (B,Sq,1)
    k_pos = torch.arange(T, device=device)[None, None, :]
    mask = (k_pos <= qp) & (k_pos < total[:, None, None])
    if window is not None:
        mask &= k_pos > qp - window
    return mask


def flash_prefill_plain(q, k, v, *, prefix_len=0, window=None, cap=None,
                        scale=None, total_len=None, return_lse=False):
    """Naive masked attention. q (B,Sq,H,hd); k,v (B,T,K,hd) with the
    chunk already written at [prefix_len, prefix_len+Sq); returns
    (B,Sq,H,hd) in q's dtype, and with ``return_lse`` the rows' LSE
    (B,Sq,H) float32 (see the module's docstring). Computes in float32, or
    in float64 for a float64 q (the tests' referee)."""
    B, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = hd ** -0.5
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, Sq, K, G, hd).to(ct)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.to(ct)) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    mask = _positions(B, Sq, T, prefix_len, total_len, window, q.device)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.to(ct))
    o = o.reshape(B, Sq, H, hd)
    if not return_lse:
        return o.to(q.dtype)
    return masked_lse(o, s, mask[:, None, None].any(-1).expand(
        B, K, G, Sq), q.dtype)


def masked_lse(o, s, seen, dtype):
    """(o, lse) of rows whose masked scores are ``s`` (B,K,G,Sq,T) and
    outputs ``o`` (B,Sq,H,hd): lse (B,Sq,H) float32 is the log-sum-exp of
    each row's scores; a row that sees no key (``seen`` (B,K,G,Sq) false)
    gets o = 0 and lse = -inf."""
    B, Sq, H, hd = o.shape
    lse = torch.where(seen, torch.logsumexp(s, dim=-1), float("-inf"))
    lse = lse.permute(0, 3, 1, 2).reshape(B, Sq, H)
    seen = seen.permute(0, 3, 1, 2).reshape(B, Sq, H, 1)
    return torch.where(seen, o, 0).to(dtype), lse.float()


def bf16_pieces(x, n):
    """x (float32) as n bf16-valued float32 tensors, largest first: piece
    i = bf16(x - piece 0 - ... - piece i-1), each remainder exact."""
    out = []
    for _ in range(n):
        p = x.to(torch.bfloat16).float()
        out.append(p)
        x = x - p
    return out


def flash_prefill_split_plain(q, k, v, *, prefix_len=0, window=None,
                              cap=None, scale=None, total_len=None,
                              pieces=3, tile=TILE):
    """The tensor-core kernel's arithmetic in plain PyTorch (tests only).
    q (B,Sq,H,hd) float32 (split into ``pieces`` bf16 pieces) or bfloat16
    (one piece); k, v (B,T,K,hd) holding bf16 values (exact tensor-core
    operands). Per sequence the keys are walked in tiles of ``tile`` from
    the window's first tile up to the chunk's causal limit; per tile S is
    the sum of the pieces' products with K, smallest first, then the
    online-softmax step (masked keys NEG_INF, p = exp(s - m_new), the
    1e-30 floor at the end), then O += sum of P's ``pieces`` bf16 pieces
    times V. Returns (B,Sq,H,hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = hd ** -0.5
    mask = _positions(B, Sq, T, prefix_len, total_len, window, "cpu")
    prefix = _per_seq(prefix_len, B, "cpu").tolist()
    total = [p + Sq for p in prefix] if total_len is None else \
        _per_seq(total_len, B, "cpu").tolist()
    # rows (kv head, position, head in group), as the kernel packs them
    rows = q.float().cpu().reshape(B, Sq, K, G, hd).permute(0, 2, 1, 3, 4)
    rows = rows.reshape(B, K, Sq * G, hd)
    qp = bf16_pieces(rows, pieces if q.dtype == torch.float32 else 1)
    kf, vf = k.float().cpu(), v.float().cpu()
    out = torch.zeros(B, K, Sq * G, hd)
    for b in range(B):
        hi = min(T, total[b], prefix[b] + Sq)
        lo = max(0, prefix[b] - window + 1) if window else 0
        lo -= lo % tile
        m = torch.full((K, Sq * G, 1), NEG_INF)
        l = torch.zeros(K, Sq * G, 1)
        acc = torch.zeros(K, Sq * G, hd)
        vis_rows = mask[b].repeat_interleave(G, dim=0)       # (Sq*G,T)
        for j0 in range(lo, hi, tile):
            j = torch.arange(j0, min(j0 + tile, hi))
            kt = kf[b, j].transpose(0, 1)                     # (K,c,hd)
            s = sum(p[b] @ kt.transpose(1, 2) for p in reversed(qp))
            s = s * scale
            if cap is not None:
                s = cap * torch.tanh(s / cap)
            s = torch.where(vis_rows[:, j][None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            m = m_new
            acc = acc * alpha + sum(
                pp @ vf[b, j].transpose(0, 1)
                for pp in reversed(bf16_pieces(p, pieces)))
        out[b] = acc / torch.clamp(l, min=1e-30)
    o = out.reshape(B, K, Sq, G, hd).permute(0, 2, 1, 3, 4)
    return o.reshape(B, Sq, H, hd).to(q.device, q.dtype)


def flash_prefill(q, k, v, *, prefix_len=0, window=None, cap=None,
                  scale=None, total_len=None, return_lse=False):
    """q (B,Sq,H,hd) float32|bfloat16; k,v (B,T,K,hd) bfloat16|float32,
    the cache buffer with the chunk written at [prefix_len,
    prefix_len+Sq). prefix_len / total_len: int or (B,) tensor
    (total_len defaults to prefix_len + Sq). Returns (B,Sq,H,hd) in q's
    dtype, or (o, lse) with ``return_lse``."""
    if build.plain_device(q):
        return flash_prefill_plain(q, k, v, prefix_len=prefix_len,
                                   window=window, cap=cap, scale=scale,
                                   total_len=total_len,
                                   return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape != (B, T, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"flash_prefill: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in build.HEAD_DIMS:
        raise ValueError(f"flash_prefill: head dim {hd}; the kernel takes "
                         f"{build.HEAD_DIMS}")
    if k.dtype != v.dtype or not (k.device == v.device == q.device):
        raise ValueError("flash_prefill: k/v dtype or device mismatch")
    if scale is None:
        scale = hd ** -0.5
    prefix = _per_seq(prefix_len, B, q.device)
    total = prefix + Sq if total_len is None else \
        _per_seq(total_len, B, q.device)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    total = total.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    launch = build.load("flash_prefill", "flash_prefill_launch", _ARGTYPES)
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        prefix.data_ptr(), total.data_ptr(), B, Sq, H, K, T, hd,
        build.dtype_code(q), build.dtype_code(k), float(scale),
        int(window or 0), float(cap or 0.0),
        None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_prefill", err, "flash_prefill")
    with _count_lock:       # engines launch from several threads
        flash_prefill.launches += 1
    return (out, lse) if return_lse else out


flash_prefill.launches = 0
