"""LLM execution engine (PyTorch counterpart of
``repro/engines/llm_engine.py``).

Runs a decoder with:
  - a per-sequence KV-cache state store (batches across queries with
    per-sequence positions),
  - decomposed ops: prefill / partial_prefill / full_prefill (chunked
    prefill against the sequence's existing KV prefix — Teola Pass 3) and
    decode / partial_decode (n-token continuation — Teola Pass 4),
  - the same bucketed (batch, chunk length) shapes as the reference,
  - an instruction prefix cache (LlamaDistPC baseline's cache-reuse),
  - the continuous decode loop (``submit_decode`` / ``decode_iteration``),
    with chunked prefill (``submit_prefill`` / ``mixed_iteration``:
    prompts advance ``prefill_chunk`` tokens at a time between decode
    iterations) and speculative decoding (``enable_speculative``).

``paged=True`` switches the KV store to the BLOCK-PAGED pool
(serving/kv_cache.py): one physical cache per replica carved into
fixed-size token blocks, per-sequence block tables, O(1) copy-on-write
prefix forks, block-level admission reservations and, with
``prefix_cache="radix"``, the global radix-tree prefix cache. The pool
is written IN PLACE under ``_paged_lock`` (the reference reassigns a
donated pool): no step copies it.

Inside ``apply_model`` the dense attention layers go through the ported
``flash_prefill`` (chunks) and ``decode_attention`` (single tokens)
kernels, and the paged layers through ``chunk_prefill_attention``
(chunks), ``verify_attention`` (speculative verify chunks) and
``paged_decode_attention`` (single tokens), and RWKV-6 layers through
``rwkv6_scan``, on CUDA; through their plain versions on the CPU. Every
forward runs under ``torch.inference_mode()``. The engine handles every
cache element by name through the tree helpers, whatever the layer: MLA's
compressed ``ckv`` / ``krope`` (dense or paged), and the per-sequence
recurrent state of RWKV-6 (``state``, ``sx_tm``, ``sx_cm``) and of
Hymba's Mamba branch (``ssm_h``, ``ssm_conv``, beside its K/V), which
lives in the dense cache and is stacked, forked and unstacked like K/V.
Recurrent layers cannot be paged: such an engine refuses ``paged=True``,
as the reference's does.

The serving-layer hooks are the reference's: SLO scheduling (a policy
armed by ``serving/slo.py::attach_slo``; preemption frees a sequence's KV
and replays it through the same prefill kernels on re-admission), fault
injection (``_fault``) and recovery (``recover_decode``), and
disaggregation (``export_seq`` / ``import_seq``, which move paged KV
blocks between replicas' pools with in-place index copies).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.engines.decode_loop import (ContinuousDecodeLoop,
                                             DecodeLoopMixin, DecodeSeq,
                                             PrefillJob)
from repro_torch.engines.tokenizer import HashTokenizer
from repro_torch.models.common import tree_map
from repro_torch.models.transformer import apply_model, init_params
from repro_torch.serving import kv_cache as kvc

BUCKETS_B = (1, 2, 4, 8, 16)
BUCKETS_S = (8, 16, 32, 64, 128, 256, 384, 512)


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class SeqState:
    cache: object               # single-sequence cache tree (B=1)
    pos: int = 0
    last_token: int = 1         # BOS


@dataclass
class PagedSeqState:
    """Paged-mode sequence handle: a block table (physical block id per
    logical block) into the replica's shared pool, instead of a private
    cache tree. Forking copies the table and bumps refcounts — O(table),
    no tensor copies."""
    table: List[int] = field(default_factory=list)
    pos: int = 0
    last_token: int = 1         # BOS


class LLMEngine(DecodeLoopMixin):
    kind = "llm"

    ALLOC_TIMEOUT = 30.0        # prefill backpressure wait (s)

    def __init__(self, name: str, cfg: ModelConfig, *, max_len: int = 512,
                 seed: int = 0, max_batch: int = 8, max_tokens: int = 1024,
                 dtype=torch.float32, stream_chunk: int = 4,
                 paged: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 chunked_prefill: bool = False, prefill_chunk: int = 128,
                 token_budget: Optional[int] = None,
                 prefix_cache: str = "none", device="cuda"):
        """Weights are drawn from ``seed`` with a ``torch.Generator`` on
        ``device`` (replace ``params`` to load others, e.g. from
        ``bridge.decoder_params``)."""
        # chunked prefill (Sarathi-style stall-free mixed batches): with
        # the flag on, prompts are admitted into the continuous loop as
        # resumable PrefillJobs and advance prefill_chunk tokens at a
        # time between decode iterations, under the loop's per-pass
        # token_budget (None = max_batch + prefill_chunk)
        if prefill_chunk < 1 or prefill_chunk > BUCKETS_S[-1]:
            raise ValueError(
                f"prefill_chunk must be in [1, {BUCKETS_S[-1]}], got "
                f"{prefill_chunk}")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got "
                             f"{token_budget}")
        if prefix_cache not in ("none", "radix"):
            raise ValueError(
                f"prefix_cache must be 'none' or 'radix', got "
                f"{prefix_cache!r}")
        if prefix_cache == "radix" and not paged:
            raise ValueError(
                "prefix_cache='radix' requires paged=True (cached "
                "prefixes live in the refcounted block pool)")
        self.name = name
        self.cfg = cfg
        self.max_len = max_len
        self.max_batch = max_batch
        self.max_tokens = max_tokens
        self.stream_chunk = stream_chunk   # decode tokens per emitted chunk
        self.chunked_prefill = chunked_prefill
        self.prefill_chunk = int(prefill_chunk)
        self.token_budget = token_budget
        self.prefix_cache_mode = prefix_cache
        self.device = torch.device(device)
        self.tok = HashTokenizer(cfg.vocab_size)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(cfg, gen, dtype, self.device)
        self.states: Dict[str, object] = {}
        self.prefix_cache: Dict[str, object] = {}
        self._prefix_toks: Dict[str, list] = {}   # instr -> token list
        self.use_prefix_cache = False      # enabled by orchestrator warmup
        self._lock = threading.Lock()
        self.paged = paged
        self.block_size = block_size
        if paged:
            # default pool: the dense worst case (max_batch full-length
            # sequences) plus the reserved pad block
            self.num_blocks = num_blocks if num_blocks is not None else \
                1 + max_batch * kvc.blocks_for(max_len, block_size)
            # block-table width buckets (shape reuse), capped at the
            # engine's own maximum
            cap = kvc.blocks_for(max_len, block_size)
            self._blk_buckets = tuple(b for b in
                                      (1, 2, 4, 8, 16, 32, 64, 128, 256)
                                      if b < cap) + (cap,)
            self._init_pool(kvc.paged_block_bytes(cfg, block_size))
        else:
            self.num_blocks = 0
            self.radix = None
            self.meter = kvc.OccupancyMeter(kvc.bytes_per_token(cfg),
                                            decode_slots=max_batch)
        self._init_replica_state()

    def _init_pool(self, block_bytes: int):
        """Per-replica paged state: allocator, pool, reservations, lock,
        block-bound meter and radix tree."""
        self.alloc = kvc.BlockAllocator(self.num_blocks)
        self.pool = kvc.init_paged_pool(self.cfg, self.num_blocks,
                                        self.block_size, device=self.device)
        # worst-case blocks still owed to admitted decode sequences
        # (admission reservations — guarantees resident decodes never
        # hit OutOfBlocks)
        self._decode_reserved: Dict[str, int] = {}
        # serializes ALL paged-pool mutation: block planning, COW copies,
        # and the steps (prefill thread vs decode-loop thread share one
        # physical pool, written in place)
        self._paged_lock = threading.RLock()
        self.meter = kvc.OccupancyMeter(
            kvc.bytes_per_token(self.cfg), decode_slots=self.max_batch,
            allocator=self.alloc, block_size=self.block_size,
            block_bytes=block_bytes)
        self.radix = kvc.RadixPrefixCache(self.alloc, self.block_size) \
            if self.prefix_cache_mode == "radix" else None

    def _init_replica_state(self):
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0, "calls": 0,
                      "decode_iters": 0,
                      "migrations_in": 0, "migrated_blocks": 0,
                      "migrate_s": 0.0}
        # decode_iteration (loop thread) and prefill/decode batches
        # (scheduler thread) update stats concurrently
        self._stats_lock = threading.Lock()
        self._decode_loop: Optional[ContinuousDecodeLoop] = None
        self._pads: List[SeqState] = []   # reusable batch-padding states
        self.spec = None                  # SpeculativeDecoder (opt-in)
        # fault tolerance: an attached FaultInjector (None = hooks are a
        # single attribute read) and this replica's own health mark
        # (escalated by loop death / injected crash; the pool's health
        # view takes the worse of the two)
        self.faults = None
        self.health = "healthy"
        # SLO scheduling (serving/slo.py): policy attached by attach_slo
        # (None = every scheduling path as without it). _slo_ptoks
        # records each sid's prefilled token context so a preempted
        # sequence can rebuild its KV by replay; the block charge mirrors
        # try_admit reservations into the fair-share ledger.
        self.slo = None
        self._slo_ptoks: Dict[str, list] = {}
        self._slo_block_charge: Dict[str, tuple] = {}
        self._reset_batch_cache()

    def clone(self, idx: int = 1) -> "LLMEngine":
        """Pool replica: SHARED weights and tokenizer; PER-REPLICA
        sequence/KV store, lock, occupancy meter and stats. The
        instruction-prefix cache is shared in dense mode (dense states
        are portable) but PER-REPLICA in paged mode (a prefix state's
        blocks live in one replica's physical pool)."""
        c = LLMEngine.__new__(LLMEngine)
        for attr in ("cfg", "max_len", "max_batch", "max_tokens",
                     "stream_chunk", "chunked_prefill", "prefill_chunk",
                     "token_budget", "prefix_cache_mode", "device", "tok",
                     "params", "use_prefix_cache", "paged", "block_size",
                     "num_blocks"):
            setattr(c, attr, getattr(self, attr))
        c.name = f"{self.name}.r{idx}"
        c.states = {}
        c._lock = threading.Lock()
        if self.paged:
            c.prefix_cache = {}
            c._prefix_toks = {}
            c._blk_buckets = self._blk_buckets
            c._init_pool(self.meter.block_bytes)
        else:
            c.prefix_cache = self.prefix_cache
            c._prefix_toks = self._prefix_toks
            c.radix = None
            c.meter = kvc.OccupancyMeter(self.meter.bytes_per_tok,
                                         decode_slots=c.max_batch)
        c._init_replica_state()
        return c

    def enable_speculative(self, draft: "LLMEngine" = None, k: int = 4,
                           max_ngram: int = 3):
        """Attach a SpeculativeDecoder to this replica: decode paths
        (run-to-completion batches AND the continuous decode loop) switch
        to draft-k/verify-once iterations. ``draft`` is a co-located
        draft engine; None drafts via model-free prompt lookup. Greedy
        outputs stay token-identical to the plain paths."""
        from repro_torch.engines.spec_decode import (EngineDrafter,
                                                     SpeculativeDecoder)
        if draft is not None and draft.cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft.cfg.vocab_size} != target vocab "
                f"{self.cfg.vocab_size}: draft token ids would not "
                f"transfer")
        drafter = EngineDrafter(draft) if draft is not None else None
        self.spec = SpeculativeDecoder(self, drafter=drafter, k=k,
                                       max_ngram=max_ngram)
        return self.spec

    # -- occupancy -----------------------------------------------------------
    def kv_occupancy(self) -> int:
        """Resident KV tokens on this replica (pool-router load input).
        Paged engines report allocated blocks * block_size — the true
        memory footprint, counting shared prefixes once."""
        return self.meter.tokens()

    def kv_free_blocks(self) -> Optional[int]:
        """Unreserved free pool blocks (None in dense mode) — the pool
        router's admission-backpressure input. Deliberately LOCK-FREE
        (allocator has its own lock, the reservation read is GIL-atomic):
        the router polls every replica, and _paged_lock is held across
        whole decode loops — taking it here would serialize routing
        behind a busy replica's decode."""
        if not self.paged:
            return None
        free = self.alloc.free_blocks() - self._reserved_snapshot()
        if self.radix is not None:
            # cached leaves are EVICTABLE capacity: a pool "full" of
            # sole-owner radix blocks is not exhausted — admission
            # evicts on demand — so it must not demote this replica
            free += self._evictable_snapshot()
        return max(0, free)

    def _evictable_snapshot(self) -> int:
        """Radix-cached blocks reclaimable on demand (tree is the sole
        owner). LOCK-FREE on the radix side — the mirror list is rebound,
        never mutated — so wait predicates and the router can call this
        without risking lock-order inversion against tree mutators."""
        if self.radix is None:
            return 0
        refs = self.alloc.refs_snapshot()
        return sum(1 for b in self.radix.block_snapshot() if refs[b] == 1)

    def _reserved_less_evictable(self) -> int:
        """wait_for_free predicate input: reservations minus the radix
        tree's reclaimable blocks — a prefill waiter whose need is
        covered by free + evictable wakes up, and the authoritative
        under-lock recheck in _acquire_with_blocks performs the actual
        eviction."""
        return self._reserved_snapshot() - self._evictable_snapshot()

    def prefix_match_len(self, text: str) -> int:
        """Longest radix-cached token prefix of ``text`` (0 without the
        radix cache) — the pool router's prefix-affinity probe.
        Read-only: no increfs, no LRU touches."""
        if self.radix is None:
            return 0
        toks = self.tok.encode(text)
        if len(toks) < 2:
            return 0
        return self.radix.match_len(toks[:len(toks) - 1])

    # -- batched forward steps ----------------------------------------------
    # Dense steps write the chunk into the stacked cache; paged steps
    # write it into self.pool through the tables (caller holds
    # _paged_lock). Decode steps return the logits of the last position,
    # prefill steps those at each row's last real token, verify steps
    # those of every chunk position (the causal position mask keeps draft
    # token i blind to drafts > i, so one forward scores the whole chunk).
    def _step(self, tokens, cache, pos):
        with torch.inference_mode():
            logits, cache = apply_model(self.cfg, self.params, tokens, cache,
                                        pos, logits_slice=1)
        return logits[:, -1], cache

    def _pstep(self, tokens, cache, pos, last_idx):
        with torch.inference_mode():
            logits, cache = apply_model(self.cfg, self.params, tokens, cache,
                                        pos, logits_at=last_idx)
        return logits[:, 0], cache

    def _vstep(self, tokens, cache, pos):
        with torch.inference_mode():
            return apply_model(self.cfg, self.params, tokens, cache, pos)

    def _paged_step(self, tokens, tables, pos):
        with torch.inference_mode():
            logits, _ = apply_model(self.cfg, self.params, tokens, self.pool,
                                    pos, logits_slice=1, block_tables=tables)
        return logits[:, -1]

    def _paged_pstep(self, tokens, tables, pos, last_idx):
        with torch.inference_mode():
            logits, _ = apply_model(self.cfg, self.params, tokens, self.pool,
                                    pos, logits_at=last_idx,
                                    block_tables=tables)
        return logits[:, 0]

    def _paged_vstep(self, tokens, tables, pos):
        with torch.inference_mode():
            logits, _ = apply_model(self.cfg, self.params, tokens, self.pool,
                                    pos, block_tables=tables, verify=True)
        return logits

    def spec_verify(self, chunk_items, loop_sids=None):
        """ONE multi-position target forward over drafted chunks.

        chunk_items: list of (state, chunk) with chunk =
        [last_token, d1..dk] (uniform length k+1). Writes the chunk's KV
        at state positions [pos, pos+k] and returns the greedy
        next-token prediction at every chunk position as an int array of
        shape (len(items), k+1) — prediction j answers "what follows
        position pos+j". State positions are NOT advanced here; the
        caller commits the accepted prefix and rolls the rest back.

        ``loop_sids`` marks the continuous-decode-loop path: resident
        sequences hold admission reservations covering their full budget
        horizon, so the write draws down reservations directly instead
        of waiting for UNRESERVED free blocks (which would double-count
        their own reservation)."""
        S = len(chunk_items[0][1])
        B = _bucket(len(chunk_items), BUCKETS_B)
        states = [s for s, _ in chunk_items]
        toks = np.ones((B, S), np.int32)
        for i, (_, ch) in enumerate(chunk_items):
            toks[i] = ch
        if self.paged:
            if loop_sids is None:
                self._acquire_with_blocks([(s, S) for s in states])
            else:
                self._paged_lock.acquire()
            try:
                sids = loop_sids or [None] * len(states)
                for s, sid in zip(states, sids):
                    got = self._prepare_write(s, S)
                    if got and sid is not None:
                        resv = self._decode_reserved.get(sid)
                        if resv is not None:
                            self._decode_reserved[sid] = max(0, resv - got)
                tables, pos = self._table_batch(states, B, S)
                logits = self._paged_vstep(self._tensor(toks), tables, pos)
            finally:
                self._paged_lock.release()
        else:
            # pad with the engine's reusable scratch states (their rows
            # are discarded), not fresh max_len caches per call
            pad_states = states + self._pad_states(B - len(states))
            cache, pos = self._stack_states(pad_states)
            logits, cache = self._vstep(self._tensor(toks), cache, pos)
            self._unstack(cache, pad_states)
        return tracing.readback(
            torch.argmax(logits, dim=-1).cpu).numpy()[:len(states)]

    def spec_rollback(self, st, sid=None):
        """Roll back rejected draft tokens: ``st.pos`` already stands at
        the accepted prefix (stale KV beyond it is masked by position and
        overwritten by the next chunk); on the paged path additionally
        trim overshoot table blocks back to the pool. For a loop-resident
        sequence (``sid``) the freed blocks are re-credited to its
        admission reservation, preserving the no-OOM guarantee."""
        if not self.paged:
            return
        with self._paged_lock:
            freed = kvc.trim_table(self.alloc, st.table, st.pos,
                                   self.block_size)
            if freed and sid is not None:
                resv = self._decode_reserved.get(sid)
                if resv is not None:
                    self._decode_reserved[sid] = resv + freed

    def new_state(self):
        if self.paged:
            return PagedSeqState()
        return SeqState(cache=kvc.init_cache(self.cfg, 1, self.max_len,
                                             device=self.device))

    def fork_state(self, st):
        """Fork of a state: paged mode shares every block copy-on-write
        (refcount bump per table entry, no tensor copies); dense mode
        copies the KV tensors, because the port writes caches in place."""
        if self.paged:
            with self._paged_lock:
                for b in st.table:
                    self.alloc.incref(b)
                return PagedSeqState(table=list(st.table), pos=st.pos,
                                     last_token=st.last_token)
        return SeqState(cache=tree_map(torch.clone, st.cache), pos=st.pos,
                        last_token=st.last_token)

    # -- paged block planning ----------------------------------------------
    # (all helpers below require self._paged_lock held)
    def _blocks_needed(self, st: PagedSeqState, n_new: int) -> int:
        """Worst-case NEW blocks a write of n_new tokens at st.pos needs:
        table growth plus copy-on-write of shared blocks in the write
        range."""
        bs = self.block_size
        first, last = st.pos // bs, (st.pos + n_new - 1) // bs
        grow = max(0, last + 1 - len(st.table))
        cow = sum(1 for bi in range(first, min(last + 1, len(st.table)))
                  if self.alloc.refcount(st.table[bi]) > 1)
        return grow + cow

    def _prepare_write(self, st: PagedSeqState, n_new: int) -> int:
        """Make st.table cover positions [0, pos+n_new) with exclusively
        owned blocks over the write range: grow the table from the free
        list and copy-on-write any shared block about to be written —
        all COW pairs in ONE batched in-place copy, and decref only AFTER
        the copy, so concurrent owners keep seeing refcount>1 and COW
        their own writes. Returns blocks consumed (reservation
        drawdown)."""
        bs = self.block_size
        first, last = st.pos // bs, (st.pos + n_new - 1) // bs
        consumed = 0
        srcs, dsts = [], []
        for bi in range(first, last + 1):
            if bi < len(st.table):
                b = st.table[bi]
                if self.alloc.refcount(b) > 1:
                    dst = self.alloc.alloc()
                    consumed += 1
                    srcs.append(b)
                    dsts.append(dst)
                    st.table[bi] = dst
            else:
                st.table.append(self.alloc.alloc())
                consumed += 1
        if srcs:
            kvc.copy_pool_blocks(self.pool, srcs, dsts)
            for b in srcs:
                self.alloc.decref(b)
        return consumed

    def _reserved_locked(self) -> int:
        return sum(self._decode_reserved.values())

    def _reserved_snapshot(self) -> int:
        """Lock-free reservation total for wait predicates: dict(d) is a
        C-level (GIL-atomic) copy, so concurrent try_admit/release
        mutations cannot raise mid-iteration. Must NOT take _paged_lock —
        the caller holds the allocator condition, and lock-holders call
        back into the allocator (lock-order inversion)."""
        return sum(dict(self._decode_reserved).values())

    def _table_batch(self, states: List[PagedSeqState], B: int, n_new,
                     pad_new: Optional[int] = None):
        """Block-table + position tensors for a padded batch: width is the
        bucketed max of ceil((pos+n_new)/bs) — n_new a scalar or a
        per-state list; padding rows cover pad_new (default n_new) write
        positions with the reserved pad block (their writes land on
        scratch)."""
        bs = self.block_size
        ns = n_new if isinstance(n_new, list) else [n_new] * len(states)
        need = [kvc.blocks_for(s.pos + n, bs) for s, n in zip(states, ns)]
        need.append(kvc.blocks_for(
            pad_new if pad_new is not None else max(ns, default=1), bs))
        if max(need) > self._blk_buckets[-1]:
            # loud failure instead of silent table truncation
            raise ValueError(
                f"{self.name}: write needs {max(need)} blocks but tables "
                f"cap at {self._blk_buckets[-1]} (max_len {self.max_len})")
        maxblk = _bucket(max(need), self._blk_buckets)
        tables = np.full((B, maxblk), kvc.PAD_BLOCK, np.int32)
        for i, s in enumerate(states):
            n = min(len(s.table), maxblk)
            tables[i, :n] = s.table[:n]
        pos = np.zeros((B,), np.int32)
        pos[:len(states)] = [s.pos for s in states]
        return self._tensor(tables), self._tensor(pos)

    def _acquire_with_blocks(self, pairs):
        """Admission backpressure: acquire self._paged_lock WITH enough
        unreserved free blocks to cover the planned writes — `pairs` is
        [(state, n_new_tokens), ...] — (the check and the subsequent
        allocation happen under one lock hold, so admitted decodes'
        reservations cannot race in between). Waits unlocked so the
        decode loop keeps draining; caller must release the lock."""
        self._fault("alloc")
        deadline = time.time() + self.ALLOC_TIMEOUT
        timed_out = False
        while True:
            self._paged_lock.acquire()
            needed = sum(self._blocks_needed(s, n) for s, n in pairs)
            avail = self.alloc.free_blocks() - self._reserved_locked()
            if needed > avail and self.radix is not None:
                # cached leaves are evictable capacity: reclaim LRU
                # leaves before treating the pool as full
                avail += self.radix.evict(needed - avail)
            if needed <= avail:
                return
            self._paged_lock.release()
            # one authoritative under-lock recheck happens above even
            # after a wait timeout (a missed wakeup must not fail a
            # request the pool could serve)
            if timed_out:
                raise kvc.OutOfBlocks(
                    f"{self.name}: paged KV pool exhausted "
                    f"({self.alloc.capacity} blocks, "
                    f"{self.alloc.free_blocks()} free, need {needed}); "
                    f"{self._pool_diag()}")
            timed_out = not self.alloc.wait_for_free(
                needed, timeout=deadline - time.time(),
                reserved_fn=self._reserved_less_evictable)

    def _pool_diag(self) -> str:
        """Allocator diagnostics attached to exhaustion errors: what is
        holding the pool — outstanding decode reservations, evictable
        radix capacity, waiter count, resident sequences."""
        with self._paged_lock:
            reserved = sum(self._decode_reserved.values())
        evictable = self.radix.evictable_blocks() \
            if self.radix is not None else 0
        return (f"diag: reserved={reserved} evictable_radix={evictable} "
                f"waiters={self.alloc.waiters()} "
                f"resident_seqs={len(self.states)}")

    def _fault(self, point: str):
        """Fault-injection hook: a single attribute read when unarmed."""
        inj = self.faults
        if inj is not None:
            inj.fire(self, point)

    # -- batched execution -------------------------------------------------
    def _stack_states(self, states: List[SeqState]):
        cache = tree_map(lambda *xs: torch.cat(xs, dim=1),
                          *[s.cache for s in states])
        pos = torch.tensor([s.pos for s in states], dtype=torch.int32,
                           device=self.device)
        return cache, pos

    def _unstack(self, cache, states: List[SeqState]):
        for i, s in enumerate(states):
            s.cache = tree_map(lambda a, i=i: a[:, i:i + 1], cache)

    def _prefill_toks(self, items, B, S):
        """Padded (B,S) token grid + exact per-row last-chunk index."""
        toks = np.zeros((B, S), np.int32)
        last_idx = np.zeros((B,), np.int32)
        for i, (_, t) in enumerate(items):
            toks[i, :len(t)] = t[:S]
            last_idx[i] = min(len(t), S) - 1
        return toks, last_idx

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def prefill_batch(self, items):
        """items: list of (state, token_list). Pads to a (B,S) bucket and
        runs one chunked-prefill step per sequence position offset. The
        returned per-sequence logits are EXACT: gathered at chunk index
        len(t)-1, so bucketed (right-padded) prefill matches unpadded
        prefill token-for-token."""
        self._fault("prefill")
        B = _bucket(len(items), BUCKETS_B)
        S = _bucket(max(len(t) for _, t in items), BUCKETS_S)
        with tracing.span("llm.prefill", engine=self.name, rows=len(items),
                          B=B, S=S):
            toks, last_idx = self._prefill_toks(items, B, S)
            if self.paged:
                logits = self._paged_prefill(items, B, S, toks, last_idx)
            else:
                logits = self._dense_prefill_exec([s for s, _ in items], B,
                                                  toks, last_idx)
            nxt = tracing.readback(torch.argmax(logits, dim=-1).tolist)
        for i, (s, t) in enumerate(items):
            s.pos += len(t)
            s.last_token = int(nxt[i])
        with self._stats_lock:
            self.stats["prefill_tokens"] += sum(len(t) for _, t in items)
            self.stats["calls"] += 1

    def prefill_chunked(self, items, chunk: Optional[int] = None):
        """Resumable chunked prefill: advance every item's prompt by at
        most ``chunk`` tokens per step until all cursors reach the end.
        Token-identical to one monolithic ``prefill_batch`` by
        construction — each chunk is written at the state's cursor
        against the already-resident prefix. This is the synchronous
        form; the continuous loop's PrefillJob path interleaves the same
        chunks with decode iterations."""
        chunk = int(chunk or self.prefill_chunk)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        cursors = [0] * len(items)
        while True:
            sub = []
            for i, (s, t) in enumerate(items):
                if cursors[i] < len(t):
                    sub.append((s, t[cursors[i]:cursors[i] + chunk]))
                    cursors[i] += len(sub[-1][1])
            if not sub:
                return
            self.prefill_batch(sub)

    def _dense_prefill_exec(self, states, B, toks, last_idx):
        pad_states = states + [self.new_state()
                               for _ in range(B - len(states))]
        cache, pos = self._stack_states(pad_states)
        logits, cache = self._pstep(self._tensor(toks), cache, pos,
                                    self._tensor(last_idx))
        self._unstack(cache, pad_states)
        return logits

    def _paged_prefill(self, items, B, S, toks, last_idx):
        """Paged prefill: allocate/COW only the blocks the REAL tokens
        write — padding-tail positions beyond each row's last block fall
        through to the reserved pad block (the batch table defaults to
        it), and the causal mask keeps every real query blind to keys
        past its own position, so bucket padding costs zero capacity.
        One step then indexes the shared pool through the batch table."""
        states = [s for s, _ in items]
        lens = [min(len(t), S) for _, t in items]
        self._acquire_with_blocks(list(zip(states, lens)))
        try:
            for s, n in zip(states, lens):
                self._prepare_write(s, n)
            logits = self._paged_prefill_exec(states, B, S, toks, last_idx)
        finally:
            self._paged_lock.release()
        return logits

    def _paged_prefill_exec(self, states, B, S, toks, last_idx):
        """Run the paged prefill step (caller holds _paged_lock with the
        write range already prepared/COW-resolved)."""
        tables, pos = self._table_batch(states, B, S)
        return self._paged_pstep(self._tensor(toks), tables, pos,
                                 self._tensor(last_idx))

    def decode_batch(self, items, on_chunk=None):
        """items: list of (state, n_tokens). Greedy continuous decode.
        With speculative decoding enabled the batch runs draft-k/verify
        iterations (token-identical outputs, fewer target forwards);
        otherwise all sequences step together for max(n) steps (finished
        ones keep writing into their own slots but results are
        truncated). on_chunk(i, token_ids_so_far): called every
        `stream_chunk` steps per live item — the streaming-decode
        emission point."""
        if self.spec is not None:
            return self.spec.decode_batch(items, on_chunk=on_chunk)
        return self._decode_batch_base(items, on_chunk)

    def _emit_chunks(self, items, outs, emitted, t, n_max, on_chunk):
        if on_chunk and ((t + 1) % self.stream_chunk == 0
                         or t + 1 == n_max):
            for i, (_, n) in enumerate(items):
                m = min(t + 1, n)
                if m > emitted[i]:
                    emitted[i] = m
                    on_chunk(i, outs[i][:m])

    def _decode_batch_base(self, items, on_chunk=None):
        n_max = max(n for _, n in items)
        B = _bucket(len(items), BUCKETS_B)
        with tracing.span("llm.decode", engine=self.name, rows=len(items),
                          B=B, steps=n_max):
            outs = self._decode_steps(items, B, n_max, on_chunk)
        results = []
        for i, (s, n) in enumerate(items):
            s.pos += n          # overshoot steps (n_max - n) are discarded
            s.last_token = outs[i][n - 1]
            results.append(outs[i][:n])
        with self._stats_lock:
            self.stats["decode_tokens"] += sum(n for _, n in items)
            self.stats["calls"] += 1
            self.stats["decode_iters"] += n_max
        return results

    def _decode_steps(self, items, B, n_max, on_chunk):
        """The ``n_max`` steps of a run-to-completion batch, each an
        ``llm.step`` span; the tokens of every (padded) row."""
        if self.paged:
            return self._paged_decode_batch(items, B, n_max, on_chunk)
        states = [s for s, _ in items]
        pad_states = states + [self.new_state()
                               for _ in range(B - len(states))]
        cache, pos = self._stack_states(pad_states)
        cur = self._tensor([[s.last_token] for s in pad_states])
        outs = [[] for _ in pad_states]
        emitted = [0] * len(items)
        for t in range(n_max):
            with tracing.span("llm.step", step=t):
                logits, cache = self._step(cur, cache, pos)
                nxt = torch.argmax(logits, dim=-1)
                for i, tok in enumerate(tracing.readback(nxt.tolist)):
                    outs[i].append(int(tok))
            cur = nxt[:, None]
            pos = pos + 1
            self._emit_chunks(items, outs, emitted, t, n_max, on_chunk)
        self._unstack(cache, pad_states)
        return outs

    def _paged_decode_batch(self, items, B, n_max, on_chunk):
        """Run-to-completion decode over the paged pool: pre-allocate
        each sequence's OWN n-step write range (COW resolved up front),
        then step with a FIXED batch block table. A shorter member's
        position FREEZES at its own horizon once it finishes — surplus
        steps rewrite its next-to-write slot, beyond its valid region
        (or, when that slot lies past its table, are dropped by
        ``paged_write``) — so no overshoot blocks are ever allocated."""
        states = [s for s, _ in items]
        self._acquire_with_blocks(list(items))
        try:
            for s, n in items:
                self._prepare_write(s, n)
            tables, pos = self._table_batch(
                states, B, [n for _, n in items], pad_new=1)
            limit = np.ones((B,), np.int32)
            limit[:len(states)] = [s.pos + n for s, n in items]
            limit = self._tensor(limit)
            cur = np.ones((B, 1), np.int32)
            cur[:len(states), 0] = [s.last_token for s in states]
            cur = self._tensor(cur)
            outs = [[] for _ in range(B)]
            emitted = [0] * len(items)
            for t in range(n_max):
                with tracing.span("llm.step", step=t):
                    logits = self._paged_step(cur, tables, pos)
                    nxt = torch.argmax(logits, dim=-1)
                    for i, tok in enumerate(tracing.readback(nxt.tolist)):
                        outs[i].append(int(tok))
                cur = nxt[:, None]
                pos = torch.minimum(pos + 1, limit)
                self._emit_chunks(items, outs, emitted, t, n_max, on_chunk)
        finally:
            self._paged_lock.release()
        return outs

    # -- iteration-level continuous batching --------------------------------
    # (loop lifecycle — start/stop/slots — comes from DecodeLoopMixin)
    def submit_decode(self, sid: str, max_new: int, on_text=None,
                      on_done=None, slo=None) -> DecodeSeq:
        """Admit sequence `sid` into the continuous decode loop for
        `max_new` tokens. on_text(text_so_far) fires every iteration;
        on_done(seq) fires at eviction. ``slo`` is the request's SLO tag
        (ignored unless a policy is armed). Returns the DecodeSeq."""
        st = self.states[sid]
        max_new = self._clamp_new(st, max_new)
        if self.paged and \
                kvc.blocks_for(st.pos + max_new, self.block_size) > \
                self.alloc.capacity:
            raise ValueError(
                f"decode {sid}: pos {st.pos} + {max_new} new tokens can "
                f"never fit the {self.alloc.capacity}-block pool")
        seq = DecodeSeq(sid, st, max_new,
                        text_fn=lambda s: self.tok.decode(s.tokens),
                        on_text=on_text, on_done=on_done, slo=slo)
        return self.start_decode_loop().submit(seq)

    def recover_decode(self, sid: str, text: str, max_new: int,
                       failed=None, on_text=None, on_done=None,
                       slo=None) -> DecodeSeq:
        """Token-identical replay of a sequence lost on a DEAD replica
        (fault-tolerance path): re-prefill the prompt from the e-graph's
        payload, teacher-force the tokens the dead replica already
        emitted back into the KV cache, and resume greedy decode for the
        remainder. Greedy argmax is deterministic given identical weights
        and identical resident tokens, so the concatenation
        ``emitted + continued`` matches a no-fault run token for token.

        ``failed`` is the dead replica's DecodeSeq handle (its
        ``.tokens`` are the emitted prefix; host objects survive replica
        death) or None when nothing was emitted yet — e.g. the sequence's
        affinity pointed at a replica that died before its first decode."""
        emitted = [int(x) for x in getattr(failed, "tokens", [])] \
            if failed is not None else []
        self.release(sid)          # drop any stale local copy of the sid
        st, toks, ptoks = self._prepare_prefill_task(
            {"sid": sid, "text": text})
        if toks:
            self.meter.advance(sid, len(toks))
            self.prefill_batch([(st, toks)])
        if self.spec is not None:
            self.spec.note_prefill(sid, ptoks, toks)
        n = self._clamp_new(st, max_new)   # same clamp as a clean submit
        emitted = emitted[:n]
        if emitted:
            # teacher-force the emitted prefix: feeding
            # [p_prompt, e_1 .. e_{m-1}] recreates the exact pos /
            # last_token the dead replica held after emitting e_m
            feed = [st.last_token] + emitted[:-1]
            self.meter.advance(sid, len(feed))
            self.prefill_batch([(st, feed)])
        seq = DecodeSeq(sid, st, n,
                        text_fn=lambda s: self.tok.decode(s.tokens),
                        on_text=on_text, on_done=on_done, slo=slo)
        seq.tokens = list(emitted)
        seq.steps = len(emitted)
        if seq.steps >= seq.n:
            # the dead replica had already finished decoding — only the
            # completion callback was lost. Finish without the loop.
            seq.result = self.tok.decode(seq.tokens)
            seq.t_done = time.time()
            seq.done.set()
            if on_done is not None:
                on_done(seq)
            return seq
        if self.paged and \
                kvc.blocks_for(st.pos + (n - seq.steps), self.block_size) \
                > self.alloc.capacity:
            raise ValueError(
                f"decode {sid}: recovery at pos {st.pos} + "
                f"{n - seq.steps} new tokens can never fit the "
                f"{self.alloc.capacity}-block pool")
        return self.start_decode_loop().submit(seq)

    def submit_prefill(self, task: dict, on_done=None) -> PrefillJob:
        """Chunked-prefill admission into the continuous loop: the
        prompt is tokenized (and prefix forked) NOW on the caller's
        thread, then queued as a resumable PrefillJob whose chunks the
        loop packs into mixed prefill/decode passes under the token
        budget — co-resident decodes never wait behind the whole prompt.
        ``task`` uses the op_prefill dict shape (sid, text, optional
        prefix_state); on_done(job) fires on the loop thread once the
        full prompt is resident (job.error set on failure)."""
        if not self.chunked_prefill:
            raise RuntimeError(
                f"{self.name}: chunked_prefill is disabled")
        sid = task["sid"]
        st, toks, ptoks = self._prepare_prefill_task(task)

        def _done(job):
            if job.error is None and toks:
                self._radix_insert(st, ptoks, toks)
            if job.error is None and self.spec is not None:
                self.spec.note_prefill(sid, ptoks, toks)
            if on_done is not None:
                on_done(job)

        job = PrefillJob(sid, st, toks, on_done=_done, ptoks=ptoks,
                         slo=task.get("slo"))
        if not toks:
            # prompt fully covered by the forked instruction prefix —
            # nothing to write; complete without touching the loop
            job.t_done = time.time()
            job.done.set()
            _done(job)
            return job
        if self.paged and \
                kvc.blocks_for(st.pos + len(toks), self.block_size) > \
                self.alloc.capacity:
            raise ValueError(
                f"prefill {sid}: pos {st.pos} + {len(toks)} tokens can "
                f"never fit the {self.alloc.capacity}-block pool")
        return self.start_decode_loop().submit_prefill(job)

    def decode_token_cost(self, seqs) -> int:
        """Query tokens one decode pass over ``seqs`` carries (the
        loop's token-budget input): 1 per sequence, or k+1 for sequences
        the speculative decoder will verify as a chunk this pass."""
        if self.spec is None:
            return len(seqs)
        k = self.spec.k
        return sum(k + 1 if (r.n - len(r.tokens) >= k + 1 and
                             r.state.pos + k + 1 <= self.max_len) else 1
                   for r in seqs)

    def mixed_iteration(self, seqs: List[DecodeSeq], pitems):
        """One stall-free mixed pass (loop thread): the resident decode
        batch advances FIRST, then this pass's budget-bounded prefill
        chunks land back-to-back — a decode's time-between-tokens is
        bounded by one chunk's compute, never by a whole prompt's."""
        if seqs:
            self.decode_iteration(seqs)
        if pitems:
            with tracing.span("llm.prefill", engine=self.name,
                              rows=len(pitems)):
                self._prefill_chunk_step(pitems)

    def _prefill_chunk_step(self, pitems):
        """Land one bucketed prefill chunk per planned (job, n) pair and
        advance the jobs' cursors. Paged admission is NON-BLOCKING:
        chunks take only UNRESERVED free blocks (admitted decodes'
        reservations stay untouchable) and when the pool — or its lock,
        held by a scheduler-side batch — is busy, the chunk is DECLINED:
        the job stays queued and the loop retries next pass. The decode
        loop must never sleep on prefill backpressure."""
        self._fault("prefill")
        items = []                       # (job, chunk_token_list)
        if self.paged:
            if not self._paged_lock.acquire(blocking=False):
                return
            try:
                free = self.alloc.free_blocks() - self._reserved_locked()
                for job, n in pitems:
                    chunk = job.tokens[job.cursor:job.cursor + n]
                    need = self._blocks_needed(job.state, len(chunk))
                    if need > free and self.radix is not None:
                        # reclaim cached leaves (non-blocking, decrefs
                        # only) before declining the chunk
                        free += self.radix.evict(need - free)
                    if need <= free:
                        free -= need
                        items.append((job, chunk))
                if not items:
                    return
                for job, chunk in items:
                    self._prepare_write(job.state, len(chunk))
                B = _bucket(len(items), BUCKETS_B)
                S = _bucket(max(len(c) for _, c in items), BUCKETS_S)
                toks, last_idx = self._prefill_toks(
                    [(j.state, c) for j, c in items], B, S)
                logits = self._paged_prefill_exec(
                    [j.state for j, _ in items], B, S, toks, last_idx)
            finally:
                self._paged_lock.release()
        else:
            items = [(job, job.tokens[job.cursor:job.cursor + n])
                     for job, n in pitems]
            B = _bucket(len(items), BUCKETS_B)
            S = _bucket(max(len(c) for _, c in items), BUCKETS_S)
            toks, last_idx = self._prefill_toks(
                [(j.state, c) for j, c in items], B, S)
            logits = self._dense_prefill_exec(
                [j.state for j, _ in items], B, toks, last_idx)
        nxt = tracing.readback(torch.argmax(logits, dim=-1).tolist)
        for i, (job, chunk) in enumerate(items):
            job.state.pos += len(chunk)
            job.state.last_token = int(nxt[i])
            job.cursor += len(chunk)
            self.meter.advance(job.sid, len(chunk))
        with self._stats_lock:
            self.stats["prefill_tokens"] += sum(len(c) for _, c in items)
            self.stats["calls"] += 1

    def try_admit(self, seq: DecodeSeq) -> bool:
        """Block-level admission control (decode-loop hook): admit only
        when the pool's unreserved free blocks cover this sequence's
        worst-case growth, and RESERVE them — admitted sequences can then
        never hit OutOfBlocks mid-decode. Dense mode always admits.

        NON-BLOCKING on the pool lock: the loop calls this while holding
        its condition variable (which slots_free/submit and the pool
        router also take), so waiting here for a long-held _paged_lock
        (a prefill step, a run-to-completion decode) would stall routing
        for every replica. If the pool is busy, defer — the loop retries
        next iteration."""
        if not self.paged:
            return True
        if not self._paged_lock.acquire(blocking=False):
            return False
        try:
            if getattr(seq, "slo_preempted", False):
                # preempted sequence re-entering: its table is empty and
                # the whole replay horizon (recorded prompt context +
                # teacher-forced emitted tokens + remaining steps) must
                # be re-written — reserve for all of it
                horizon = len(self._slo_ptoks.get(seq.sid, ())) + seq.n
                needed = kvc.blocks_for(horizon, self.block_size)
            else:
                needed = self._blocks_needed(seq.state, seq.n)
            pol = self.slo
            if pol is not None and pol.blocks is not None:
                tenant = pol.tag_of(seq).tenant
                if not pol.may_take_blocks(tenant, needed):
                    return False    # over block fair share — defer
            avail = self.alloc.free_blocks() - self._reserved_locked()
            if needed > avail and self.radix is not None:
                # cached leaves never count AGAINST admission: they are
                # evictable capacity, reclaimed eagerly here so the
                # reservation is backed by actually-free blocks
                avail += self.radix.evict(needed - avail)
            if needed <= avail:
                self._decode_reserved[seq.sid] = needed
                if pol is not None and pol.blocks is not None:
                    pol.blocks.acquire(tenant, needed)
                    self._slo_block_charge[seq.sid] = (tenant, needed)
                return True
            return False
        finally:
            self._paged_lock.release()

    def note_slot_acquired(self, seq: DecodeSeq):
        self.meter.acquire_slot(seq.sid)

    def _slo_drop_block_charge(self, sid: str):
        """Return a sequence's KV-block charge to the fair-share ledger
        (eviction, preemption, or release — whichever comes first)."""
        charge = self._slo_block_charge.pop(sid, None)
        if charge is not None and self.slo is not None and \
                self.slo.blocks is not None:
            self.slo.blocks.release(*charge)

    def note_slot_released(self, seq: DecodeSeq):
        if self.paged:
            with self._paged_lock:
                dropped = self._decode_reserved.pop(seq.sid, None)
            self._slo_drop_block_charge(seq.sid)
            if dropped:
                # headroom improved without a decref — wake prefill waiters
                self.alloc.notify_waiters()
        else:
            # an evicted sequence's KV must be current in its own state
            # before the slot is reused (its sid may decode again later)
            self._flush_batch_cache()
        self.meter.release_slot(seq.sid)

    # -- SLO preemption (serving/slo.py): evict-to-recompute ---------------
    def can_preempt(self, seq: DecodeSeq) -> bool:
        """A sequence is preemptable only when its full KV context is
        reconstructible from the recorded prompt tokens plus its emitted
        tokens (single-decode lifecycles; a multi-turn state whose
        earlier partial-decode tokens were never recorded, or a
        migrated-in sequence with no record here, is excluded — losing
        KV we cannot rebuild would break token identity)."""
        rec = self._slo_ptoks.get(seq.sid)
        if rec is None:
            return False
        return seq.state.pos == len(rec) + len(seq.tokens)

    def preempt_decode(self, seq: DecodeSeq):
        """Evict-to-recompute (loop thread): free ALL of the sequence's
        KV — paged: trim its block table to position 0 (shared/radix
        blocks just decref); dense: drop the per-sequence cache — and
        release its decode slot, reservation and fair-share charge. The
        loop re-queues the same DecodeSeq (tokens/steps intact); on
        re-admission ``_slo_resume`` rebuilds the KV by replay."""
        sid, st = seq.sid, seq.state
        if self.paged:
            with self._paged_lock:
                kvc.trim_table(self.alloc, st.table, 0, self.block_size)
                dropped = self._decode_reserved.pop(sid, None)
            self._slo_drop_block_charge(sid)
            if dropped:
                self.alloc.notify_waiters()
        else:
            # write the shared batch cache back first (residency is
            # changing), then drop this sequence's KV arrays
            self._flush_batch_cache()
            st.cache = kvc.init_cache(self.cfg, 1, self.max_len,
                                      device=self.device)
        st.pos = 0
        st.last_token = 1                # replay re-derives it
        seq.slo_preempted = True
        self.meter.release(sid)          # tokens gone from memory
        self.meter.release_slot(sid)

    def _slo_resume(self, seq: DecodeSeq):
        """Rebuild a preempted sequence's KV before it rejoins a decode
        pass: re-prefill the recorded prompt context, then teacher-force
        the already-emitted tokens — the same construction as
        ``recover_decode``, so causal attention recreates the exact
        pre-preemption state and the continuation is token-identical.
        Paged writes draw down the sequence's re-admission reservation
        (sized for the whole replay horizon in try_admit)."""
        sid, st = seq.sid, seq.state
        seq.slo_preempted = False
        toks = list(self._slo_ptoks.get(sid, []))
        if toks:
            self._slo_replay_write(sid, st, toks)
        emitted = [int(x) for x in seq.tokens]
        if emitted:
            self._slo_replay_write(sid, st,
                                   [st.last_token] + emitted[:-1])

    def _slo_replay_write(self, sid: str, st, toks: list):
        """Prefill ``toks`` for a resuming sequence, bucketed-chunk by
        chunk. Paged mode bypasses free-block admission: the blocks come
        out of the sequence's own decode reservation."""
        i = 0
        while i < len(toks):
            chunk = toks[i:i + BUCKETS_S[-1]]
            i += len(chunk)
            B = _bucket(1, BUCKETS_B)
            S = _bucket(len(chunk), BUCKETS_S)
            grid, last_idx = self._prefill_toks([(st, chunk)], B, S)
            if self.paged:
                with self._paged_lock:
                    got = self._prepare_write(st, len(chunk))
                    if got:
                        resv = self._decode_reserved.get(sid)
                        if resv is not None:
                            self._decode_reserved[sid] = max(0,
                                                             resv - got)
                    logits = self._paged_prefill_exec(
                        [st], B, S, grid, last_idx)
            else:
                logits = self._dense_prefill_exec([st], B, grid, last_idx)
            st.pos += len(chunk)
            st.last_token = int(tracing.readback(
                torch.argmax(logits[0]).item))
            self.meter.advance(sid, len(chunk))
        with self._stats_lock:
            self.stats["prefill_tokens"] += len(toks)
            self.stats["calls"] += 1

    def tenant_stats(self) -> dict:
        """Per-(tenant, class) scheduling stats (empty when SLO
        scheduling is not armed on this replica)."""
        return self.slo.tenant_stats() if self.slo is not None else {}

    def _pad_states(self, k: int) -> List[SeqState]:
        while len(self._pads) < k:
            self._pads.append(self.new_state())
        return self._pads[:k]

    def _reset_batch_cache(self):
        self._batch_key = None         # tuple of resident DecodeSeq ids
        self._batch_cache = None       # persistent stacked cache tree
        self._batch_pos = None
        self._batch_states: List[SeqState] = []

    def _flush_batch_cache(self):
        """Write the persistent stacked decode cache back into the
        per-sequence states (on residency change / eviction). Loop-thread
        only, like decode_iteration."""
        if self._batch_cache is not None:
            self._unstack(self._batch_cache, self._batch_states)
        self._reset_batch_cache()

    def decode_iteration(self, seqs: List[DecodeSeq]):
        """One loop pass for every resident sequence. With speculative
        decoding enabled, sequences with enough remaining budget advance
        by a whole verified draft chunk per pass (the loop counts their
        emitted tokens); the rest — and everything, with it disabled —
        take the single-token step."""
        self._fault("decode")
        with tracing.span("llm.step", engine=self.name, rows=len(seqs)):
            if self.slo is not None:
                for r in seqs:
                    if getattr(r, "slo_preempted", False):
                        self._slo_resume(r)
            if self.spec is not None:
                return self.spec.decode_iteration(seqs)
            return self._decode_iteration_base(seqs)

    def _decode_iteration_base(self, seqs: List[DecodeSeq]):
        """One decode step for every resident sequence (called by the
        loop each iteration). The stacked batch cache persists across
        iterations and is rebuilt only when RESIDENCY changes (admission
        or eviction). KV occupancy advances per iteration.

        In PAGED mode residency changes are free: there is no stacked
        batch cache at all — every iteration scatters one token per
        sequence into the shared pool through a block table rebuilt from
        host-side lists."""
        B = _bucket(len(seqs), BUCKETS_B)
        if self.paged:
            with self._paged_lock:
                for r in seqs:
                    got = self._prepare_write(r.state, 1)
                    if got:
                        resv = self._decode_reserved.get(r.sid)
                        if resv is not None:
                            self._decode_reserved[r.sid] = max(0,
                                                               resv - got)
                states = [r.state for r in seqs]
                tables, pos = self._table_batch(states, B, 1)
                cur = np.ones((B, 1), np.int32)
                cur[:len(states), 0] = [s.last_token for s in states]
                logits = self._paged_step(self._tensor(cur), tables, pos)
        else:
            key = tuple(id(r) for r in seqs)
            if key != self._batch_key:
                self._flush_batch_cache()
                self._batch_states = [r.state for r in seqs] + \
                    self._pad_states(B - len(seqs))
                self._batch_cache, self._batch_pos = \
                    self._stack_states(self._batch_states)
                self._batch_key = key
            cur = self._tensor([[s.last_token] for s in self._batch_states])
            logits, self._batch_cache = self._step(cur, self._batch_cache,
                                                   self._batch_pos)
            self._batch_pos = self._batch_pos + 1
        nxt = tracing.readback(torch.argmax(logits, dim=-1).tolist)
        for i, r in enumerate(seqs):
            tok = int(nxt[i])
            r.state.pos += 1
            r.state.last_token = tok
            r.tokens.append(tok)
            self.meter.advance(r.sid, 1)
        with self._stats_lock:
            self.stats["decode_tokens"] += len(seqs)
            self.stats["decode_iters"] += 1

    # -- high-level ops used by the schedulers ------------------------------
    def _match_prefix_locked(self, toks):
        """Longest cached instruction whose TOKEN sequence prefixes
        `toks` (self._lock held). Returns (prefix_state, prefix_tokens)
        or (None, None)."""
        best_st, best_ptoks = None, None
        for instr, st in self.prefix_cache.items():
            ptoks = self._prefix_toks.get(instr)
            if ptoks is None:
                ptoks = self._prefix_toks[instr] = self.tok.encode(instr)
            if len(ptoks) <= len(toks) and toks[:len(ptoks)] == ptoks \
                    and (best_ptoks is None or len(ptoks) > len(best_ptoks)):
                best_st, best_ptoks = st, ptoks
        return best_st, best_ptoks

    def _radix_fork_locked(self, toks):
        """Radix-cache front half of a fresh prefill: fork the longest
        cached block-aligned prefix. The match is capped at len-1 so at
        least one token always prefills — the forked sequence's
        next-token logits are then computed fresh, exactly as on the
        cold path. Returns (state, prefix_tokens, suffix_tokens)."""
        # cap at len-1 (>= 1 token must prefill) AND max_len-9 (the
        # suffix must survive _prepare_prefill_task's max_len clamp —
        # a radix fork's last_token is a placeholder until it does)
        cap = max(0, min(len(toks) - 1, self.max_len - 9))
        with self._paged_lock:
            blocks, mlen = self.radix.match_prefix(toks[:cap])
        if not mlen:
            return self.new_state(), [], toks
        st = PagedSeqState(table=blocks, pos=mlen)
        return st, toks[:mlen], toks[mlen:]

    def _radix_insert(self, st, ptoks, toks):
        """Publish a completed prefill's full-block prefix into the
        radix tree (incref'd by the tree; the sequence keeps its own
        refs, so release() never strips cached blocks). Skipped when the
        state's position doesn't equal the known token count — explicit
        prefix-state forks with unknown prefix tokens and partial-
        prefill continuations must not be cached under a wrong key."""
        if self.radix is None:
            return
        full = list(ptoks) + list(toks)
        full = full[: (len(full) // self.block_size) * self.block_size]
        if not full or st.pos != len(list(ptoks) + list(toks)):
            return
        with self._paged_lock:
            self.radix.insert(full, st.table)

    def _prepare_prefill_task(self, t: dict):
        """Per-task prefill front half (shared by op_prefill and
        submit_prefill): resolve/create the sequence state, fork a
        cached prefix when one matches, and return
        (state, tokens_to_prefill, prefix_tokens). Empty tokens mean the
        forked prefix already covers the whole prompt."""
        sid = t["sid"]
        toks = self.tok.encode(t["text"])
        forked = False
        ptoks = []
        with self._lock:
            st = self.states.get(sid)
            if st is None:
                ps = t.get("prefix_state")
                if ps is None and self.radix is not None:
                    # the GENERAL mechanism: any cached block-aligned
                    # token prefix forks, warmed instruction or not
                    st, ptoks, toks = self._radix_fork_locked(toks)
                    forked = bool(ptoks)
                else:
                    if ps is not None:
                        ptoks = self._prefix_tokens_of_locked(ps)
                    elif self.use_prefix_cache:
                        ps, mtoks = self._match_prefix_locked(toks)
                        if ps is not None:
                            ptoks = mtoks
                            toks = toks[len(mtoks):]
                    st = self.fork_state(ps) if ps is not None \
                        else self.new_state()
                    forked = ps is not None
                self.states[sid] = st
        # the reference's clamp: it bounds the real tokens, not the
        # bucketed chunk, whose dense cache write then clamps
        # (write_linear)
        toks = toks[: self.max_len - st.pos - 8]
        if forked and not toks:
            # prompt == cached instruction: the forked state is already
            # complete (pos and last_token carried over)
            out = []
        else:
            out = toks or [HashTokenizer.SEP]
        if self.slo is not None:
            # preemption replay record: every token that becomes part of
            # this sid's KV context through a prefill path (cached
            # prefixes included — replay re-prefills them fresh, same
            # numerics)
            self._slo_ptoks.setdefault(sid, []).extend(
                list(ptoks) + list(out))
        return st, out, ptoks

    def op_prefill(self, task_batch):
        """task_batch: list of dicts with keys:
        sid, text, continue_partial(bool), prefix_state(optional).

        With ``use_prefix_cache`` on (set by the orchestrator's prefix
        warmup), a FRESH sequence whose prompt starts with a cached
        instruction forks that instruction's KV state instead of
        re-prefilling it — in paged mode an O(table) copy-on-write block
        share. Only the remaining suffix tokens are prefilled (chunked
        prefill makes this exactly equivalent to prefilling the whole
        prompt).

        With ``chunked_prefill`` on, prompts STREAM through the
        continuous loop as budget-bounded PrefillJob chunks instead of
        one monolithic forward — this scheduler thread blocks until the
        prompt is resident, but the engine keeps interleaving decode
        iterations, so co-resident decodes never stall."""
        if self.chunked_prefill:
            jobs = [self.submit_prefill(t) for t in task_batch]
            for job in jobs:
                job.wait(300)     # raises the job's error on failure
            return [None] * len(task_batch)
        items = []
        notes = []            # (sid, prefix_tokens, suffix_tokens)
        for t in task_batch:
            st, toks, ptoks = self._prepare_prefill_task(t)
            notes.append((t["sid"], ptoks, toks))
            if not toks:
                continue
            self.meter.advance(t["sid"], len(toks))
            items.append((st, toks))
        if items:
            self.prefill_batch(items)
        if self.radix is not None:
            # publish AFTER the forward pass so cached blocks always
            # hold fully-written KV
            for sid, ptoks, toks in notes:
                if toks:
                    self._radix_insert(self.states[sid], ptoks, toks)
        if self.spec is not None:
            # record token contexts (prompt-lookup drafting) and mirror
            # the prefill onto the draft engine — AFTER the prefill so
            # each state's next-token prediction is final
            for sid, ptoks, toks in notes:
                self.spec.note_prefill(sid, ptoks, toks)
        return [None] * len(task_batch)

    def _prefix_tokens_of_locked(self, ps) -> list:
        """Token list of an explicitly passed prefix state (identity
        lookup against the instruction cache; self._lock held). Unknown
        states map to []."""
        for instr, st in self.prefix_cache.items():
            if st is ps:
                toks = self._prefix_toks.get(instr)
                if toks is None:
                    toks = self._prefix_toks[instr] = self.tok.encode(instr)
                return list(toks)
        return []

    def _clamp_new(self, st, n: int) -> int:
        """Cap a decode request to the sequence's remaining KV capacity —
        writes past max_len would clamp into the last cache slots (dense)
        or fall off the table (paged)."""
        cap = self.max_len - st.pos
        if cap <= 0:
            raise ValueError(
                f"{self.name}: sequence at pos {st.pos} has no KV "
                f"capacity left (max_len {self.max_len})")
        return min(int(n), cap)

    def op_decode(self, task_batch, on_chunk=None):
        """task_batch: list of dicts: sid, max_new (capped to the
        sequence's remaining max_len capacity). Returns texts.
        on_chunk(i, text_so_far): incremental decode emission."""
        items = []
        for t in task_batch:
            st = self.states[t["sid"]]
            n = self._clamp_new(st, int(t["max_new"]))
            self.meter.advance(t["sid"], n)
            items.append((st, n))
        cb = None
        if on_chunk is not None:
            cb = lambda i, ids: on_chunk(i, self.tok.decode(ids))  # noqa: E731
        outs = self.decode_batch(items, on_chunk=cb)
        return [self.tok.decode(o) for o in outs]

    def get_prefix_state(self, instruction: str):
        """Instruction-prefix KV cache (LlamaDistPC cache-reuse)."""
        with self._lock:
            st = self.prefix_cache.get(instruction)
        if st is None:
            st = self.new_state()
            toks = self.tok.encode(instruction)
            self.prefill_batch([(st, toks)])
            with self._lock:
                self.prefix_cache[instruction] = st
                self._prefix_toks[instruction] = toks
            # with the radix cache on, warmup seeds the GLOBAL tree too
            # — a cold replica and a warmed one then serve identical
            # forks whether or not the orchestrator warmed them
            self._radix_insert(st, [], toks)
        return st

    def release(self, sid: str):
        if self.spec is not None:
            self.spec.release(sid)     # drop ctx + draft-engine mirror
        with self._lock:
            st = self.states.pop(sid, None)
        if self.paged and st is not None:
            with self._paged_lock:
                for b in st.table:
                    self.alloc.decref(b)      # frees when refcount hits 0
                dropped = self._decode_reserved.pop(sid, None)
            if dropped:
                self.alloc.notify_waiters()
        self._slo_drop_block_charge(sid)
        self._slo_ptoks.pop(sid, None)
        self.meter.release(sid)

    # -- sequence migration (disaggregated prefill/decode handoff) ---------
    def export_seq(self, sid: str) -> dict:
        """Snapshot sequence ``sid`` for migration to another replica
        (``dst.import_seq(handle)``). The sequence stays fully resident
        HERE until the import lands — on import failure nothing was
        lost. A prompt still mid-flight in this engine's chunked-prefill
        queue is detached first (cursor frozen); its remaining tokens
        travel in the handle and resume on the destination. The caller
        must not export a sequence while it is actively decoding in the
        loop (serving migrates between prefill completion and decode
        submission)."""
        job = None
        loop = self._decode_loop
        if loop is not None and loop.is_alive():
            job = loop.detach_prefill(sid)
        with self._lock:
            st = self.states[sid]
        ctx = self.spec.export_ctx(sid) if self.spec is not None else None
        return {"sid": sid, "engine": self, "state": st,
                "paged": self.paged, "block_size": self.block_size,
                "spec_ctx": ctx, "job": job}

    def import_seq(self, handle) -> Optional[PrefillJob]:
        """Adopt a sequence exported from another replica so it resumes
        decoding here TOKEN-IDENTICALLY. This is the engine-level form
        of ``kv_cache.migrate_blocks``, phased so each pool's lock is
        held only for the phase touching it (the destination's decode
        loop keeps iterating while the source stages blocks — migration
        cost overlaps the loop's cadence):

          1. reserve len(table) destination blocks under THIS pool's
             lock, with the same backpressure/radix-eviction wait as
             prefill admission (all-or-nothing: on timeout the source
             is untouched);
          2. stage the source blocks out under the SOURCE pool's lock
             (gather only reads — the source keeps serving);
          3. scatter the staged blocks into the reserved slots under
             this pool's lock and register the sequence, then release
             the source atomically (``src.release`` drops exactly the
             sequence's own refs — blocks shared with the source's
             radix tree or COW forks survive there; every block here is
             freshly allocated, refcount 1: the migrated copy is
             sequence-private and is NOT inserted into this replica's
             prefix cache).

        Returns the continuation PrefillJob when the handle carried a
        mid-flight prompt (completing it also completes the original
        job so source-side waiters unblock), else None."""
        self._fault("migrate")
        src, sid, st = handle["engine"], handle["sid"], handle["state"]
        if src is self:
            # self-import: nothing moves; re-queue a detached job
            job = handle.get("job")
            if job is not None and job.remaining() and \
                    not job.done.is_set():
                return self.start_decode_loop().submit_prefill(job)
            return None
        if handle["paged"] != self.paged or \
                (self.paged and handle["block_size"] != self.block_size):
            raise ValueError(
                f"{self.name}: cannot import {sid} from "
                f"{getattr(src, 'name', '?')} (paged/block_size mismatch)")
        t0 = time.time()
        n_blocks = 0
        if self.paged:
            n_blocks = len(st.table)
            dst_table = self._acquire_import_blocks(n_blocks)
            if n_blocks:
                # the gather and the scatter are queued on the current
                # stream in this order; src.release below only decrefs
                # host-side bookkeeping, and a reused source block is
                # written by a later kernel on the same stream, after the
                # gather has read it
                with src._paged_lock:
                    stage = kvc.gather_pool_blocks(src.pool, st.table)
                with self._paged_lock:
                    kvc.scatter_pool_blocks(self.pool, stage, dst_table)
            new_st = PagedSeqState(table=dst_table, pos=st.pos,
                                   last_token=st.last_token)
        else:
            # dense states are portable — adopt the object
            new_st = st
        with self._lock:
            self.states[sid] = new_st
        self.meter.advance(sid, new_st.pos)
        if self.spec is not None and handle.get("spec_ctx"):
            self.spec.import_ctx(sid, handle["spec_ctx"], new_st)
        src.release(sid)                 # atomic source-side release
        with self._stats_lock:
            self.stats["migrations_in"] += 1
            self.stats["migrated_blocks"] += n_blocks
            self.stats["migrate_s"] += time.time() - t0
        job = handle.get("job")
        if job is not None and job.remaining() and not job.done.is_set():
            return self._resume_prefill(sid, new_st, job)
        return None

    def _acquire_import_blocks(self, n: int) -> List[int]:
        """Reserve ``n`` fresh pool blocks for an incoming migration
        with the same backpressure as ``_acquire_with_blocks``: wait
        unlocked (the decode loop keeps draining), evict radix leaves
        under pressure, honor admitted decodes' reservations, and time
        out loudly. Returns the reserved block list (each refcount 1);
        the paged lock is NOT held on return — allocated blocks cannot
        be taken by anyone else."""
        self._fault("alloc")
        deadline = time.time() + self.ALLOC_TIMEOUT
        timed_out = False
        while True:
            with self._paged_lock:
                avail = self.alloc.free_blocks() - self._reserved_locked()
                if n > avail and self.radix is not None:
                    avail += self.radix.evict(n - avail)
                if n <= avail:
                    return kvc.reserve_blocks(self.alloc, n)
            if timed_out:
                raise kvc.OutOfBlocks(
                    f"{self.name}: cannot reserve {n} blocks for an "
                    f"incoming migration ({self.alloc.capacity} blocks, "
                    f"{self.alloc.free_blocks()} free); "
                    f"{self._pool_diag()}")
            timed_out = not self.alloc.wait_for_free(
                n, timeout=deadline - time.time(),
                reserved_fn=self._reserved_less_evictable)

    def _resume_prefill(self, sid: str, st, old: PrefillJob) -> PrefillJob:
        """Continue a mid-flight chunked prefill after migration: the
        remaining prompt tokens stream through THIS engine's loop (or
        land synchronously when this engine is not chunked). The original
        job object is completed when the continuation lands so exporters'
        waiters unblock; its ``on_done`` chain is NOT re-fired — those
        hooks (source-engine radix insert, spec note) belong to the
        source, and the migrated copy is sequence-private here."""
        pending = list(old.tokens[old.cursor:])

        def _done(job):
            if job.error is None and self.spec is not None:
                # full-job context, exactly what the source would have
                # noted at completion (where the compute ran is
                # irrelevant to the token stream)
                self.spec.note_prefill(sid, list(old.ptoks),
                                       list(old.tokens))
            old.t_done = time.time()
            old.error = job.error
            old.done.set()

        job = PrefillJob(sid, st, pending, on_done=_done, ptoks=old.ptoks)
        if self.chunked_prefill:
            return self.start_decode_loop().submit_prefill(job)
        # monolithic destination: land the remainder now
        try:
            self.meter.advance(sid, len(pending))
            self.prefill_batch([(st, pending)])
            job.cursor = len(pending)
        except Exception as e:  # noqa: BLE001
            job.error = e
        job.t_done = time.time()
        if job.error is None and self.spec is not None:
            self.spec.note_prefill(sid, list(old.ptoks), list(old.tokens))
        old.t_done = job.t_done
        old.error = job.error
        job.done.set()
        old.done.set()
        return job
