"""LLM execution engine, dense KV path (PyTorch counterpart of
``repro/engines/llm_engine.py`` with ``paged=False``).

Runs a decoder with:
  - a per-sequence KV-cache state store (batches across queries with
    per-sequence positions),
  - decomposed ops: prefill / partial_prefill / full_prefill (chunked
    prefill against the sequence's existing KV prefix — Teola Pass 3) and
    decode / partial_decode (n-token continuation — Teola Pass 4),
  - the same bucketed (batch, chunk length) shapes as the reference,
  - an instruction prefix cache (LlamaDistPC baseline's cache-reuse),
  - the continuous decode loop (``submit_decode`` / ``decode_iteration``).

Inside ``apply_model`` the dense attention layers go through the ported
``flash_prefill`` (chunks) and ``decode_attention`` (single tokens)
kernels on CUDA, and through their plain versions on the CPU. Every
forward runs under ``torch.inference_mode()``. The paged KV pool, chunked
prefill, the radix prefix cache and speculative decoding are not ported
yet: asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engines.decode_loop import (ContinuousDecodeLoop,
                                             DecodeLoopMixin, DecodeSeq)
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


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                              f"Queue 1, {item})")


class LLMEngine(DecodeLoopMixin):
    kind = "llm"

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
        ``bridge.decoder_params``). ``block_size``, ``num_blocks``,
        ``prefill_chunk`` and ``token_budget`` belong to the paths not
        ported yet and are accepted for signature parity only."""
        if paged:
            _not_ported("paged=True (paged KV pool)", "item 6")
        if chunked_prefill:
            _not_ported("chunked_prefill=True", "item 7")
        if prefix_cache != "none":
            _not_ported(f"prefix_cache={prefix_cache!r} (radix cache)",
                        "item 6")
        self.name = name
        self.cfg = cfg
        self.max_len = max_len
        self.max_batch = max_batch
        self.max_tokens = max_tokens
        self.stream_chunk = stream_chunk   # decode tokens per emitted chunk
        self.device = torch.device(device)
        self.tok = HashTokenizer(cfg.vocab_size)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(cfg, gen, dtype, self.device)
        self.states: Dict[str, SeqState] = {}
        self.prefix_cache: Dict[str, SeqState] = {}
        self._prefix_toks: Dict[str, list] = {}   # instr -> token list
        self.use_prefix_cache = False      # enabled by orchestrator warmup
        self._lock = threading.Lock()
        self.meter = kvc.OccupancyMeter(kvc.bytes_per_token(cfg),
                                        decode_slots=max_batch)
        self._init_replica_state()

    def _init_replica_state(self):
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0, "calls": 0,
                      "decode_iters": 0, "busy_s": 0.0}
        # decode_iteration (loop thread) and prefill/decode batches
        # (scheduler thread) update stats concurrently
        self._stats_lock = threading.Lock()
        self._decode_loop: Optional[ContinuousDecodeLoop] = None
        self._pads: List[SeqState] = []   # reusable batch-padding states
        self.health = "healthy"           # the decode loop marks a death
        self._reset_batch_cache()

    def clone(self, idx: int = 1) -> "LLMEngine":
        """Pool replica: SHARED weights and tokenizer; PER-REPLICA
        sequence/KV store, lock, occupancy meter and stats. The
        instruction-prefix cache is shared (dense states are portable)."""
        c = LLMEngine.__new__(LLMEngine)
        for attr in ("cfg", "max_len", "max_batch", "max_tokens",
                     "stream_chunk", "device", "tok", "params",
                     "use_prefix_cache", "prefix_cache", "_prefix_toks"):
            setattr(c, attr, getattr(self, attr))
        c.name = f"{self.name}.r{idx}"
        c.states = {}
        c._lock = threading.Lock()
        c.meter = kvc.OccupancyMeter(self.meter.bytes_per_tok,
                                     decode_slots=c.max_batch)
        c._init_replica_state()
        return c

    def enable_speculative(self, *args, **kwargs):
        _not_ported("speculative decoding", "item 7")

    def kv_occupancy(self) -> int:
        """Resident KV tokens on this replica (pool-router load input)."""
        return self.meter.tokens()

    def kv_free_blocks(self) -> Optional[int]:
        """Unreserved free pool blocks: None on the dense path."""
        return None

    # -- batched forward steps: write the chunk, return logits of the last
    # (real) position
    def _step(self, tokens, cache, pos):
        with torch.inference_mode():
            logits, cache = apply_model(self.cfg, self.params, tokens, cache,
                                        pos, logits_slice=1)
        return logits[:, -1], cache

    def _pstep(self, tokens, cache, pos, last_idx):
        # exact bucketed prefill: per-sequence logits at chunk index
        # len(t)-1 (not the padded tail)
        with torch.inference_mode():
            logits, cache = apply_model(self.cfg, self.params, tokens, cache,
                                        pos, logits_at=last_idx)
        return logits[:, 0], cache

    def new_state(self):
        return SeqState(cache=kvc.init_cache(self.cfg, 1, self.max_len,
                                             device=self.device))

    def fork_state(self, st):
        """Copy of a state: the port writes caches in place, so a fork
        owns its own copy of the KV tensors."""
        return SeqState(cache=tree_map(torch.clone, st.cache), pos=st.pos,
                        last_token=st.last_token)

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
        t0 = time.time()
        B = _bucket(len(items), BUCKETS_B)
        S = _bucket(max(len(t) for _, t in items), BUCKETS_S)
        toks, last_idx = self._prefill_toks(items, B, S)
        logits = self._dense_prefill_exec([s for s, _ in items], B, toks,
                                          last_idx)
        nxt = torch.argmax(logits, dim=-1).tolist()
        for i, (s, t) in enumerate(items):
            s.pos += len(t)
            s.last_token = int(nxt[i])
        with self._stats_lock:
            self.stats["prefill_tokens"] += sum(len(t) for _, t in items)
            self.stats["calls"] += 1
            self.stats["busy_s"] += time.time() - t0

    def prefill_chunked(self, items, chunk: Optional[int] = None):
        """Resumable chunked prefill: advance every item's prompt by at
        most ``chunk`` tokens per step until all cursors reach the end.
        Token-identical to one monolithic ``prefill_batch`` by
        construction — each chunk is written at the state's cursor
        against the already-resident prefix."""
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

    def decode_batch(self, items, on_chunk=None):
        """items: list of (state, n_tokens). Greedy decode: all sequences
        step together for max(n) steps (finished ones keep writing into
        their own slots but results are truncated). on_chunk(i,
        token_ids_so_far): called every `stream_chunk` steps per live item
        — the streaming-decode emission point."""
        t0 = time.time()
        n_max = max(n for _, n in items)
        B = _bucket(len(items), BUCKETS_B)
        states = [s for s, _ in items]
        pad_states = states + [self.new_state()
                               for _ in range(B - len(states))]
        cache, pos = self._stack_states(pad_states)
        cur = self._tensor([[s.last_token] for s in pad_states])
        outs = [[] for _ in pad_states]
        emitted = [0] * len(items)
        for t in range(n_max):
            logits, cache = self._step(cur, cache, pos)
            nxt = torch.argmax(logits, dim=-1)
            for i, tok in enumerate(nxt.tolist()):
                outs[i].append(int(tok))
            cur = nxt[:, None]
            pos = pos + 1
            if on_chunk and ((t + 1) % self.stream_chunk == 0
                             or t + 1 == n_max):
                for i, (_, n) in enumerate(items):
                    m = min(t + 1, n)
                    if m > emitted[i]:
                        emitted[i] = m
                        on_chunk(i, outs[i][:m])
        self._unstack(cache, pad_states)
        results = []
        for i, (s, n) in enumerate(items):
            s.pos += n          # overshoot steps (n_max - n) are discarded
            s.last_token = outs[i][n - 1]
            results.append(outs[i][:n])
        with self._stats_lock:
            self.stats["decode_tokens"] += sum(n for _, n in items)
            self.stats["calls"] += 1
            self.stats["busy_s"] += time.time() - t0
        return results

    # -- iteration-level continuous batching --------------------------------
    # (loop lifecycle — start/stop/slots — comes from DecodeLoopMixin)
    def submit_decode(self, sid: str, max_new: int, on_text=None,
                      on_done=None, slo=None) -> DecodeSeq:
        """Admit sequence `sid` into the continuous decode loop for
        `max_new` tokens. on_text(text_so_far) fires every iteration;
        on_done(seq) fires at eviction. Returns the DecodeSeq."""
        if slo is not None:
            _not_ported("SLO scheduling", "item 8")
        st = self.states[sid]
        max_new = self._clamp_new(st, max_new)
        seq = DecodeSeq(sid, st, max_new,
                        text_fn=lambda s: self.tok.decode(s.tokens),
                        on_text=on_text, on_done=on_done)
        return self.start_decode_loop().submit(seq)

    def note_slot_acquired(self, seq: DecodeSeq):
        self.meter.acquire_slot(seq.sid)

    def note_slot_released(self, seq: DecodeSeq):
        # an evicted sequence's KV must be current in its own state
        # before the slot is reused (its sid may decode again later)
        self._flush_batch_cache()
        self.meter.release_slot(seq.sid)

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
        """One decode step for every resident sequence (called by the
        loop each iteration). The stacked batch cache persists across
        iterations and is rebuilt only when RESIDENCY changes (admission
        or eviction). KV occupancy advances per iteration."""
        t0 = time.time()
        B = _bucket(len(seqs), BUCKETS_B)
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
        nxt = torch.argmax(logits, dim=-1).tolist()
        for i, r in enumerate(seqs):
            tok = int(nxt[i])
            r.state.pos += 1
            r.state.last_token = tok
            r.tokens.append(tok)
            self.meter.advance(r.sid, 1)
        with self._stats_lock:
            self.stats["decode_tokens"] += len(seqs)
            self.stats["decode_iters"] += 1
            self.stats["busy_s"] += time.time() - t0

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

    def _prepare_prefill_task(self, t: dict):
        """Per-task prefill front half: resolve/create the sequence state,
        fork a cached instruction prefix when one matches, and return
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
        # bucketed chunk, whose cache write then clamps (write_linear)
        toks = toks[: self.max_len - st.pos - 8]
        if forked and not toks:
            # prompt == cached instruction: the forked state is already
            # complete (pos and last_token carried over)
            out = []
        else:
            out = toks or [HashTokenizer.SEP]
        return st, out, ptoks

    def op_prefill(self, task_batch):
        """task_batch: list of dicts with keys:
        sid, text, continue_partial(bool), prefix_state(optional).

        With ``use_prefix_cache`` on (set by the orchestrator's prefix
        warmup), a FRESH sequence whose prompt starts with a cached
        instruction forks that instruction's KV state instead of
        re-prefilling it; only the remaining suffix tokens are prefilled
        (chunked prefill makes this exactly equivalent to prefilling the
        whole prompt)."""
        items = []
        for t in task_batch:
            st, toks, _ = self._prepare_prefill_task(t)
            if not toks:
                continue
            self.meter.advance(t["sid"], len(toks))
            items.append((st, toks))
        if items:
            self.prefill_batch(items)
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
        writes past max_len would clamp into the last cache slots and
        corrupt them."""
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

    def get_prefix_state(self, instruction: str) -> SeqState:
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
        return st

    def release(self, sid: str):
        with self._lock:
            self.states.pop(sid, None)
        self.meter.release(sid)
