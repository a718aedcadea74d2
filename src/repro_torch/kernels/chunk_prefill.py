"""Chunked-prefill attention over the block-paged KV pool (K5): a prompt
chunk at absolute positions ``start[b] + i`` attends to the sequence's
paged prefix and to itself (the paged form of Teola's Partial/Full
Prefilling, and every chunk of a chunked prefill).

Replaces the Pallas TPU kernel ``src/repro/kernels/chunk_prefill.py::
chunk_prefill_attention`` (``_chunk_kernel``) with a CUDA kernel written
for Hopper, ``repro_torch/csrc/chunk_prefill.cu``: K1's tensor-core tile
kernel (``csrc/flash_tile.cuh``: GQA-packed 128-row tiles, 64 at head dim
256, bf16 K/V staged by cp.async, both products on wgmma with an fp32 q
and the fp32 probabilities in three bf16 pieces each) reading K/V rows
through the
block table straight from the ``(nb, bs, K, hd)`` pool, with the
reference's causal block skip. Those files say what bounds it on the H100
and how the design follows from that.

``chunk_prefill_attention`` launches the kernel for CUDA tensors and runs
``chunk_prefill_attention_plain`` — the verify oracle at total length
``start + Sq``, over the gathered view — for CPU tensors. There is no
fallback between the two: a CUDA call that cannot launch raises.
``chunk_prefill_attention.launches`` counts kernel launches.

``chunk_prefill_split_plain`` mirrors the kernel's arithmetic in plain
PyTorch (K1's ``flash_prefill_split_plain`` over the gathered view). Only
the tests use it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill import flash_prefill_split_plain
from repro_torch.kernels.paged_attention import (check_paged_args,
                                                 paged_gather, per_seq,
                                                 verify_attention_plain)

_count_lock = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k_pool, v_pool, o, tables, start, B, Sq, H, K, bs, maxblk, hd, q_dtype,
# kv_dtype, scale, window, cap, stream
_ARGTYPES = [_P] * 6 + [_I] * 9 + [_F, _I, _F, _P]


def chunk_prefill_attention_plain(q, k_pool, v_pool, block_tables, start, *,
                                  window=None, cap=None, scale=None):
    """q (B,Sq,H,hd); pools (nb,bs,K,hd); block_tables (B,maxblk); start
    (B,) chunk-start positions (tokens resident before the chunk, whose own
    KV is already in the pool). Returns (B,Sq,H,hd) in q's dtype."""
    start = per_seq(start, q.shape[0], q.device)
    return verify_attention_plain(q, k_pool, v_pool, block_tables,
                                  start + q.shape[1], window=window, cap=cap,
                                  scale=scale)


def chunk_prefill_split_plain(q, k_pool, v_pool, block_tables, start, *,
                              window=None, cap=None, scale=None, pieces=3):
    """The tensor-core kernel's arithmetic in plain PyTorch (tests only):
    ``flash_prefill_split_plain`` over the gathered view, chunk row i of
    sequence b at ``start[b] + i`` and total length ``start[b] + Sq``.
    Pools hold bf16 values (exact tensor-core operands). Returns
    (B,Sq,H,hd) in q's dtype."""
    start = per_seq(start, q.shape[0], "cpu")
    return flash_prefill_split_plain(
        q, paged_gather(k_pool, block_tables),
        paged_gather(v_pool, block_tables), prefix_len=start,
        total_len=start + q.shape[1], window=window, cap=cap, scale=scale,
        pieces=pieces)


def chunk_prefill_attention(q, k_pool, v_pool, block_tables, start, *,
                            window=None, cap=None, scale=None):
    """q (B,Sq,H,hd) float32|bfloat16, row i of sequence b at absolute
    position ``start[b] + i``; k_pool, v_pool (nb,bs,K,hd); block_tables
    (B,maxblk); start (B,) int. Returns (B,Sq,H,hd) in q's dtype. Sq == 1
    at start = length - 1 reduces to ``paged_decode_attention``."""
    if build.plain_device(q):
        return chunk_prefill_attention_plain(q, k_pool, v_pool, block_tables,
                                             start, window=window, cap=cap,
                                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"chunk_prefill_attention: unsupported device "
                         f"{q.device}")
    B, Sq, H, hd = q.shape
    tables = check_paged_args("chunk_prefill_attention", q, k_pool, v_pool,
                              block_tables)
    if scale is None:
        scale = hd ** -0.5
    start = per_seq(start, B, q.device)
    q = q.contiguous()
    out = torch.empty_like(q)
    launch = build.load("chunk_prefill", "chunk_prefill_launch", _ARGTYPES)
    err = launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        tables.data_ptr(), start.data_ptr(), B, Sq, H, k_pool.shape[2],
        k_pool.shape[1], tables.shape[1], hd, build.dtype_code(q),
        build.dtype_code(k_pool), float(scale), int(window or 0),
        float(cap or 0.0), torch.cuda.current_stream(q.device).cuda_stream)
    build.check("chunk_prefill", err, "chunk_prefill_attention")
    with _count_lock:       # engines launch from several threads
        chunk_prefill_attention.launches += 1
    return out


chunk_prefill_attention.launches = 0
