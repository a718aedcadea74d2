"""Chunked-prefill flash attention against a resident KV prefix (Teola's
Partial/Full Prefilling, paper §4.2 Pass 3).

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_prefill.py::
flash_prefill`` (``_kernel``) with a CUDA kernel written for Hopper,
``repro_torch/csrc/flash_prefill.cu``. That file's header says what bounds
it on the H100 (compute: fp32 on the CUDA cores in this first version)
and how its tiling follows from that.

``flash_prefill`` launches the kernel for CUDA tensors and runs
``flash_prefill_plain`` — the same function in plain PyTorch — for CPU
tensors. There is no fallback between the two: a CUDA call that cannot
launch raises. ``flash_prefill.launches`` counts kernel launches.

Unlike the reference, ``prefix_len`` (and ``total_len``) may be a (B,)
tensor: the serving engine batches sequences at different positions.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e38

_count_lock = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, prefix, total, B, Sq, H, K, T, hd, q_dtype, kv_dtype, scale,
# window, cap, stream
_ARGTYPES = [_P] * 6 + [_I] * 8 + [_F, _I, _F, _P]


def _per_seq(x, B, device):
    """int | (B,) tensor -> (B,) int32 tensor on ``device``."""
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    return torch.broadcast_to(t, (B,)).contiguous()


def flash_prefill_plain(q, k, v, *, prefix_len=0, window=None, cap=None,
                        scale=None, total_len=None):
    """Naive masked attention. q (B,Sq,H,hd); k,v (B,T,K,hd) with the
    chunk already written at [prefix_len, prefix_len+Sq); returns
    (B,Sq,H,hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = hd ** -0.5
    prefix = _per_seq(prefix_len, B, q.device).long()
    total = prefix + Sq if total_len is None else \
        _per_seq(total_len, B, q.device).long()
    qg = q.reshape(B, Sq, K, G, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    q_pos = prefix[:, None] + torch.arange(Sq, device=q.device)[None, :]
    k_pos = torch.arange(T, device=q.device)[None, None, :]
    qp = q_pos[:, :, None]                                   # (B,Sq,1)
    mask = (k_pos <= qp) & (k_pos < total[:, None, None])
    if window is not None:
        mask &= k_pos > qp - window
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_prefill(q, k, v, *, prefix_len=0, window=None, cap=None,
                  scale=None, total_len=None):
    """q (B,Sq,H,hd) float32|bfloat16; k,v (B,T,K,hd) bfloat16|float32,
    the cache buffer with the chunk written at [prefix_len,
    prefix_len+Sq). prefix_len / total_len: int or (B,) tensor
    (total_len defaults to prefix_len + Sq). Returns (B,Sq,H,hd) in q's
    dtype."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, prefix_len=prefix_len,
                                   window=window, cap=cap, scale=scale,
                                   total_len=total_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape != (B, T, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"flash_prefill: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"flash_prefill: head dim {hd} not in (64, 128)")
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
    launch = build.load("flash_prefill", "flash_prefill_launch", _ARGTYPES)
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        prefix.data_ptr(), total.data_ptr(), B, Sq, H, K, T, hd,
        build.dtype_code(q), build.dtype_code(k), float(scale),
        int(window or 0), float(cap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_prefill", err, "flash_prefill")
    with _count_lock:       # engines launch from several threads
        flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
