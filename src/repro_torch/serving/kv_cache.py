"""KV cache management, dense half (PyTorch counterpart of
``repro/serving/kv_cache.py``).

Cache layout mirrors the model's stage/pattern structure:

    cache = {
      'stages': [ [elem_cache, ...pattern elems], ...stages ],
    }

where each attention ``elem_cache`` is ``{'k': (R,B,T,K,hd), 'v': ...}``
with a leading ``repeat`` dim (stacked across the layers of the stage).
Sliding-window layers hold a ring buffer of ``T = min(window + chunk,
max_len)`` slots (rounded up to 256). K/V are stored in bfloat16.

Sequence length is a per-sequence position ``pos`` passed to the model
(all layers advance in lockstep). Unlike the functional reference, the
writes here update the cache tensors IN PLACE (the engine owns every
buffer it passes in) and return them.

The paged pool, block allocator and radix cache are not ported yet
(ROADMAP.md Queue 1, item 6).
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig

KV_DTYPE = torch.bfloat16


def elem_cache_shape(cfg: ModelConfig, spec: LayerSpec, repeat: int,
                     batch: int, max_len: int, chunk: int = 256):
    """Returns {name: (shape, dtype)} for one pattern element.

    Sliding-window layers get a ring buffer of `window + chunk` slots
    (capped at max_len): a chunked write of S tokens needs window+S-1
    live slots for every query in the chunk to see its full window."""
    if spec.kind != "attn" or cfg.attention_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: only GQA attention layers are ported "
            f"(ROADMAP.md Queue 1, item 10)")
    hd = cfg.resolved_head_dim
    if spec.window is None:
        T = max_len
    else:
        T = min(-(-(spec.window + chunk) // 256) * 256, max_len)
    shape = (repeat, batch, T, cfg.num_kv_heads, hd)
    return {"k": (shape, KV_DTYPE), "v": (shape, KV_DTYPE)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               chunk: int = 256, device="cuda"):
    """chunk: largest prefill chunk the caller will write (sizes the
    sliding-window ring buffers)."""
    stages = []
    for st in cfg.stages:
        elems = []
        for spec in st.pattern:
            shapes = elem_cache_shape(cfg, spec, st.repeat, batch, max_len,
                                      chunk)
            elems.append({name: torch.zeros(shape, dtype=dtype,
                                            device=device)
                          for name, (shape, dtype) in shapes.items()})
        stages.append(elems)
    return {"stages": stages}


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int,
                chunk: int = 256) -> int:
    total = 0
    for st in cfg.stages:
        for spec in st.pattern:
            for shape, dtype in elem_cache_shape(
                    cfg, spec, st.repeat, batch, max_len, chunk).values():
                n = 1
                for s in shape:
                    n *= s
                total += n * dtype.itemsize
    return total


# ---------------------------------------------------------------------------
# Occupancy accounting (engine-pool load routing)

def bytes_per_token(cfg: ModelConfig, chunk: int = 256) -> int:
    """Marginal KV bytes per resident token, amortized over a reference
    window (sliding-window layers make the true cost sub-linear; a
    1k-token reference captures the steady state)."""
    ref = 1024
    return max(1, cache_bytes(cfg, 1, ref, chunk) // ref)


class OccupancyMeter:
    """Per-replica ledger of resident sequence tokens and decode slots.

    Engines advance the token ledger on prefill/decode and clear entries
    on release; the pool router reads ``tokens()`` as the KV-occupancy
    component of a replica's load. ``decode_slots`` adds admitted-slot
    introspection for the continuous decode loop. (The block-bound mode
    of the reference, for paged engines, is not ported yet.)"""

    def __init__(self, bytes_per_tok: int = 0, decode_slots: int = 0):
        self.bytes_per_tok = bytes_per_tok
        self.decode_slots = decode_slots
        self._tokens: Dict[str, int] = {}
        self._slot_sids: set = set()
        self._lock = threading.Lock()

    def advance(self, sid: str, n: int):
        with self._lock:
            self._tokens[sid] = self._tokens.get(sid, 0) + int(n)

    def release(self, sid: str):
        with self._lock:
            self._tokens.pop(sid, None)

    def tokens(self) -> int:
        with self._lock:
            return sum(self._tokens.values())

    def bytes(self) -> int:
        return self.tokens() * self.bytes_per_tok

    def seqs(self) -> int:
        with self._lock:
            return len(self._tokens)

    # -- decode-slot accounting (continuous batching) ----------------------
    def acquire_slot(self, sid: str):
        with self._lock:
            self._slot_sids.add(sid)

    def release_slot(self, sid: str):
        with self._lock:
            self._slot_sids.discard(sid)

    def slots_used(self) -> int:
        with self._lock:
            return len(self._slot_sids)

    def slots_free(self) -> int:
        with self._lock:
            return max(0, self.decode_slots - len(self._slot_sids))


# ---------------------------------------------------------------------------
# Position bookkeeping (linear and ring-buffer caches)

def batch_pos(pos, batch: int, device=None):
    """Normalize pos (python int / scalar / (B,) vector) to (B,) int32 —
    per-sequence positions enable continuous batching in the engines."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return torch.broadcast_to(pos, (batch,))


def write_linear(buf, chunk, pos):
    """buf (B,T,...), chunk (B,S,...): write row b at [pos_b, pos_b+S),
    in place. Like ``jax.lax.dynamic_update_slice`` in the reference, the
    start is clamped to [0, T-S], so a chunk that would run past the end
    lands at T-S instead."""
    B, T = buf.shape[0], buf.shape[1]
    S = chunk.shape[1]
    pos = batch_pos(pos, B, buf.device).long()
    start = torch.clamp(pos, 0, T - S)
    idx = start[:, None] + torch.arange(S, device=buf.device)[None, :]
    rows = torch.arange(B, device=buf.device)[:, None]
    buf[rows, idx] = chunk.to(buf.dtype)
    return buf


def write_ring(buf, chunk, pos):
    """Ring-buffer write, in place: absolute positions pos_b..pos_b+S-1
    land at (pos_b+i) % W. Used by sliding-window layers."""
    B, W = buf.shape[0], buf.shape[1]
    S = chunk.shape[1]
    pos = batch_pos(pos, B, buf.device).long()
    idx = (pos[:, None] + torch.arange(S, device=buf.device)[None, :]) % W
    rows = torch.arange(B, device=buf.device)[:, None]
    buf[rows, idx] = chunk.to(buf.dtype)
    return buf


def slot_positions_linear(T, length):
    """Absolute position held by each slot of a linear cache of size T given
    per-seq total length (B,); -1 for unwritten slots. Returns (B,T)."""
    slot = torch.arange(T, device=length.device)[None, :]
    return torch.where(slot < length[:, None], slot, -1)


def slot_positions_ring(W, length):
    """Absolute position held by each ring slot; -1 if unwritten.
    Slot i holds the largest p < length_b with p % W == i. Returns (B,W)."""
    i = torch.arange(W, device=length.device)[None, :]
    L = length[:, None].long()
    p = (L - 1) - torch.remainder(L - 1 - i, W)
    return torch.where((p >= 0) & (L > 0), p, -1)
