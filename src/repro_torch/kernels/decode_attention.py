"""Batched GQA decode attention over a dense KV cache (one new token per
sequence, dynamic per-sequence valid length).

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py::
decode_attention`` (``_kernel``, ``_flash_block``) with a CUDA kernel
written for Hopper, ``repro_torch/csrc/decode_attention.cu``. That file's
header says what bounds it on the H100 (memory: about 2*G flops per byte
of K/V) and what its design does about that.

``decode_attention`` launches the kernel for CUDA tensors and runs
``decode_attention_plain`` — the same function in plain PyTorch — for CPU
tensors. There is no fallback between the two: a CUDA call that cannot
launch raises. ``decode_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e38
MAX_GROUP = 16       # query heads per kv head the kernel holds

_count_lock = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, length, B, H, K, T, hd, q_dtype, kv_dtype, scale, window, cap,
# stream
_ARGTYPES = [_P] * 5 + [_I] * 7 + [_F, _I, _F, _P]


def decode_attention_plain(q, k, v, length, *, window=None, cap=None,
                           scale=None):
    """q (B,H,hd); k,v (B,T,K,hd); length (B,) valid cache lengths (the
    new token's KV already written at length-1). Returns (B,H,hd) in q's
    dtype."""
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
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention(q, k, v, length, *, window=None, cap=None, scale=None):
    """q (B,H,hd) float32|bfloat16; k,v (B,T,K,hd) bfloat16|float32;
    length (B,) int. Returns (B,H,hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length, window=window,
                                      cap=cap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape != (B, T, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in (64, 128) or H // K > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {hd} not in (64, 128)"
                         f" or group {H // K} > {MAX_GROUP}")
    if k.dtype != v.dtype or not (k.device == v.device == q.device):
        raise ValueError("decode_attention: k/v dtype or device mismatch")
    if scale is None:
        scale = hd ** -0.5
    length = torch.broadcast_to(
        torch.as_tensor(length, dtype=torch.int32, device=q.device),
        (B,)).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    launch = build.load("decode_attention", "decode_attention_launch",
                        _ARGTYPES)
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        length.data_ptr(), B, H, K, T, hd, build.dtype_code(q),
        build.dtype_code(k), float(scale), int(window or 0),
        float(cap or 0.0), torch.cuda.current_stream(q.device).cuda_stream)
    build.check("decode_attention", err, "decode_attention")
    with _count_lock:       # engines launch from several threads
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
