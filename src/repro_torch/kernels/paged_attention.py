"""GQA attention over the block-paged KV pool: one query per sequence
(paged decode, K4) and a chunk of Sq queries per sequence (speculative
verification, K3).

Replaces the Pallas TPU kernels ``src/repro/kernels/decode_attention.py::
paged_decode_attention`` (``_paged_kernel``) and ``::verify_attention``
(``_verify_kernel``) with one CUDA source written for Hopper,
``repro_torch/csrc/paged_attention.cu``. That file's header says what
bounds each on the H100 (memory: about Sq*G flops per byte of K/V; at
serve sizes, latency) and what its design does about that. Both read K/V
rows through the block table straight from the ``(nb, bs, K, hd)`` pool,
so the pool is never transposed, copied or gathered. Both are the split-KV
(flash-decoding) kernel of ``csrc/split_kv.cuh`` that K2 also uses: a
split pass over chunks of 64 keys and a combine pass, from one C call,
with a per-call workspace (its plain mirror for the tests:
``decode_attention.split_kv_plain`` over the gathered view). K4 is its
``Sq = 1`` case, under an addressing type of its own so that its launches
and kernel names stay apart from K3's.

``paged_decode_attention`` and ``verify_attention`` launch the kernels for
CUDA tensors and run their plain PyTorch versions — a gather of the
sequence's linear view through its table, then masked attention — for CPU
tensors. There is no fallback between the two: a CUDA call that cannot
launch raises. Each wrapper's ``launches`` counts its calls that launched
the kernels.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (NEG_INF,
                                                  decode_attention_plain,
                                                  split_workspace)

MAX_GROUP = 16       # query heads per kv head the decode kernel holds
MAX_ROWS = 64        # Sq * G rows the verify kernel holds

_count_lock = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k_pool, v_pool, o, tables, length, ws, ws_floats, B, H, K, bs,
# maxblk, hd, q_dtype, kv_dtype, scale, window, cap, stream
_DECODE_ARGTYPES = ([_P] * 7 + [ctypes.c_longlong] + [_I] * 8
                    + [_F, _I, _F, _P])
# q, k_pool, v_pool, o, tables, length, ws, ws_floats, B, Sq, H, K, bs,
# maxblk, hd, q_dtype, kv_dtype, scale, window, cap, stream
_VERIFY_ARGTYPES = ([_P] * 7 + [ctypes.c_longlong] + [_I] * 9
                    + [_F, _I, _F, _P])


def paged_gather(pool, block_tables):
    """(nb, bs, ...) pool, (B, maxblk) tables -> the (B, maxblk*bs, ...)
    linear view of every sequence (``repro/models/attention.py::
    paged_gather``)."""
    B, maxblk = block_tables.shape
    g = pool[block_tables.long()]                 # (B, maxblk, bs, ...)
    return g.reshape(B, maxblk * pool.shape[1], *pool.shape[2:])


def per_seq(x, B, device):
    """int | (B,) tensor -> (B,) contiguous int32 tensor on ``device``."""
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    return torch.broadcast_to(t, (B,)).contiguous()


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, length,
                                 *, window=None, cap=None, scale=None):
    """q (B,H,hd); pools (nb,bs,K,hd); block_tables (B,maxblk); length (B,)
    valid lengths (the new token's KV already written at length-1).
    Dense decode attention over the gathered view. Returns (B,H,hd)."""
    return decode_attention_plain(q, paged_gather(k_pool, block_tables),
                                  paged_gather(v_pool, block_tables), length,
                                  window=window, cap=cap, scale=scale)


def verify_attention_plain(q, k_pool, v_pool, block_tables, length, *,
                           window=None, cap=None, scale=None):
    """q (B,Sq,H,hd); pools (nb,bs,K,hd); block_tables (B,maxblk); length
    (B,) total valid length INCLUDING the Sq chunk positions (query i sits
    at length - Sq + i). Masked attention over the gathered view, causal
    inside the chunk. Returns (B,Sq,H,hd) in q's dtype. Computes in
    float32, or in float64 for a float64 q (the tests' referee)."""
    B, Sq, H, hd = q.shape
    k = paged_gather(k_pool, block_tables)
    v = paged_gather(v_pool, block_tables)
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if scale is None:
        scale = hd ** -0.5
    length = per_seq(length, B, q.device).long()
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, Sq, K, G, hd).to(ct)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.to(ct)) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    q_pos = (length[:, None] - Sq
             + torch.arange(Sq, device=q.device)[None, :])[:, :, None]
    k_pos = torch.arange(T, device=q.device)[None, None, :]
    mask = k_pos <= q_pos                                     # (B,Sq,T)
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.to(ct))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def check_paged_args(what, q, k_pool, v_pool, block_tables, rows=1,
                     max_rows=1):
    """Validate a paged kernel call on CUDA tensors (``rows`` query rows
    per kv head held by one CTA, at most ``max_rows``); returns the int32
    tables. The pools are never copied: a non-contiguous pool raises."""
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    nb, bs, K = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    if k_pool.shape != (nb, bs, K, hd) or v_pool.shape != k_pool.shape \
            or H % K or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pool.shape)} {tuple(v_pool.shape)} "
                         f"tables {tuple(block_tables.shape)}")
    if hd not in build.HEAD_DIMS or rows > max_rows:
        raise ValueError(f"{what}: head dim {hd}, {rows} query rows per kv "
                         f"head; the kernel takes head dims "
                         f"{build.HEAD_DIMS} and up to {max_rows} rows")
    if k_pool.dtype != v_pool.dtype or \
            not (k_pool.device == v_pool.device == block_tables.device
                 == q.device):
        raise ValueError(f"{what}: pool dtype or device mismatch")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{what}: pools must be contiguous (the kernel "
                         f"reads them in place)")
    return block_tables.to(torch.int32).contiguous()


def paged_decode_attention(q, k_pool, v_pool, block_tables, length, *,
                           window=None, cap=None, scale=None):
    """q (B,H,hd) float32|bfloat16; k_pool, v_pool (nb,bs,K,hd) shared
    pools; block_tables (B,maxblk) physical block per logical block;
    length (B,) valid lengths. Returns (B,H,hd) in q's dtype."""
    if build.plain_device(q):
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            length, window=window, cap=cap,
                                            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    B, H, hd = q.shape
    tables = check_paged_args("paged_decode_attention", q, k_pool, v_pool,
                              block_tables, H // k_pool.shape[2], MAX_GROUP)
    if scale is None:
        scale = hd ** -0.5
    length = per_seq(length, B, q.device)
    q = q.contiguous()
    out = torch.empty_like(q)
    K, bs = k_pool.shape[2], k_pool.shape[1]
    ws = split_workspace(B, K, tables.shape[1] * bs, H // K, hd, q.device)
    launch = build.load("paged_attention", "paged_decode_launch",
                        _DECODE_ARGTYPES)
    err = launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        tables.data_ptr(), length.data_ptr(), ws.data_ptr(), ws.numel(), B,
        H, K, bs, tables.shape[1], hd, build.dtype_code(q),
        build.dtype_code(k_pool), float(scale), int(window or 0),
        float(cap or 0.0), torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_attention", err, "paged_decode_attention")
    with _count_lock:       # engines launch from several threads
        paged_decode_attention.launches += 1
    return out


def verify_attention(q, k_pool, v_pool, block_tables, length, *,
                     window=None, cap=None, scale=None):
    """q (B,Sq,H,hd) float32|bfloat16: the drafted chunk's queries;
    k_pool, v_pool (nb,bs,K,hd); block_tables (B,maxblk); length (B,)
    TOTAL valid length including the chunk (query i sits at
    length - Sq + i; its KV already scattered into the pool). Returns
    (B,Sq,H,hd) in q's dtype."""
    if build.plain_device(q):
        return verify_attention_plain(q, k_pool, v_pool, block_tables,
                                      length, window=window, cap=cap,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"verify_attention: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    tables = check_paged_args("verify_attention", q, k_pool, v_pool,
                              block_tables, Sq * (H // k_pool.shape[2]),
                              MAX_ROWS)
    if scale is None:
        scale = hd ** -0.5
    length = per_seq(length, B, q.device)
    q = q.contiguous()
    out = torch.empty_like(q)
    K, bs = k_pool.shape[2], k_pool.shape[1]
    ws = split_workspace(B, K, tables.shape[1] * bs, Sq * (H // K), hd,
                         q.device)
    launch = build.load("paged_attention", "verify_attention_launch",
                        _VERIFY_ARGTYPES)
    err = launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        tables.data_ptr(), length.data_ptr(), ws.data_ptr(), ws.numel(), B,
        Sq, H, K, bs, tables.shape[1], hd, build.dtype_code(q),
        build.dtype_code(k_pool), float(scale), int(window or 0),
        float(cap or 0.0), torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_attention", err, "verify_attention")
    with _count_lock:
        verify_attention.launches += 1
    return out


paged_decode_attention.launches = 0
verify_attention.launches = 0
