"""Speculative decoding: draft–verify engine pairing (a copy of
``repro/engines/spec_decode.py``; it holds no tensors).

Teola's end-to-end breakdown shows the core-LLM generation primitive
dominating application latency even after graph-level parallelization,
and the app pool already co-locates a cheap ``lite_llm`` next to
``core_llm``. Speculative decoding turns that co-location into raw
decode speed: a DRAFTER proposes k tokens per iteration and the target
verifies all of them in ONE multi-position forward pass
(``LLMEngine.spec_verify`` — q_len = k+1 with a causal intra-chunk mask;
the ``kernels/paged_attention.py::verify_attention`` kernel on the paged
path), accepting the longest prefix that matches the target's own
greedy choices plus one bonus token from the first disagreeing position.

Correctness contract: greedy speculative output is TOKEN-IDENTICAL to
baseline greedy decode — every emitted token is an argmax of the target
model's logits given exactly the baseline prefix, so acceptance only
changes how many target forwards are spent, never what is generated.
Rejected draft tokens are rolled back by NOT advancing ``pos`` past the
accepted prefix (stale KV beyond ``pos`` is masked and overwritten by
the next chunk); on the paged path overshoot blocks are additionally
trimmed back to the pool (``kv_cache.trim_table``) so rejections never
hold memory.

Two drafters:

  ``PromptLookupDrafter`` — model-free n-gram prompt lookup: match the
      tail of the token context against earlier context and propose the
      continuation (free to run, wins on repetitive/extractive text).
      Always available; also the automatic fallback when an engine
      drafter cannot serve a sequence.
  ``EngineDrafter``      — a real draft ``LLMEngine`` (e.g. the pooled
      ``lite_llm`` replica co-located with the target replica — see
      ``engine_pool.pair_replicas``). Mirrors each target sequence on
      the draft engine (same tokenizer family + vocab => identical token
      ids), proposes k greedy draft steps per iteration, and is re-synced
      to the accepted prefix after every verification.

``attach_speculative`` wires a built engine set: every target replica is
paired with its index-aligned draft replica (co-location) or the
model-free drafter.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional


class PromptLookupDrafter:
    """Model-free prompt-lookup (n-gram) drafter.

    Finds the most recent earlier occurrence of the context's trailing
    m-gram (longest m first) and proposes the k tokens that followed it;
    with no match it repeats the last token (a guess is free — wrong
    drafts cost nothing but the already-paid verify slot)."""

    kind = "ngram"

    def __init__(self, max_ngram: int = 3):
        self.max_ngram = int(max_ngram)

    def propose(self, ctx: List[int], k: int) -> List[int]:
        n = len(ctx)
        if n == 0:
            return [1] * k
        for m in range(min(self.max_ngram, n - 1), 0, -1):
            pat = ctx[n - m:]
            for start in range(n - m - 1, -1, -1):
                if ctx[start:start + m] == pat:
                    cont = ctx[start + m:start + m + k]
                    if cont:
                        return (cont + [cont[-1]] * k)[:k]
        return [ctx[-1]] * k


class EngineDrafter:
    """Draft-model proposals from a real ``LLMEngine``.

    Maintains a MIRROR sequence per target sid on the draft engine
    (created/extended from the target's prefilled tokens — same hash
    tokenizer + vocab, so token ids transfer verbatim). ``propose`` runs
    k greedy draft steps; ``sync`` rolls the mirror back to the accepted
    prefix (filling any position the draft never wrote when the whole
    chunk was accepted). Draft-side failures (pool exhaustion, capacity)
    drop the mirror and return None — the decoder falls back to prompt
    lookup, never failing the target decode."""

    kind = "engine"

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()

    def _drop(self, sid: str):
        try:
            self.engine.release(sid)
        except Exception:  # noqa: BLE001 — cleanup must never propagate
            pass

    def extend(self, sid: str, tokens: List[int], last_token: int):
        """Mirror a target prefill: write `tokens` onto the draft
        sequence and adopt the target's next-token prediction."""
        eng = self.engine
        with self._lock:
            with eng._lock:
                st = eng.states.get(sid)
                if st is None:
                    st = eng.new_state()
                    eng.states[sid] = st
            try:
                toks = list(tokens)[: eng.max_len - st.pos - 8]
                if toks:
                    eng.prefill_batch([(st, toks)])
            except Exception:  # noqa: BLE001 — degrade to prompt lookup
                self._drop(sid)
                return
            st.last_token = int(last_token)

    def propose(self, sid: str, k: int) -> Optional[List[int]]:
        eng = self.engine
        with self._lock:
            st = eng.states.get(sid)
            if st is None:
                return None
            kd = min(k, eng.max_len - st.pos)
            if kd < 1:
                return None
            try:
                out = eng._decode_batch_base([(st, kd)])[0]
            except Exception:  # noqa: BLE001 — degrade to prompt lookup
                self._drop(sid)
                return None
            return (out + [out[-1]] * k)[:k]

    def sync(self, sid: str, base_pos: int, chunk: List[int], pos_t: int,
             last_token: int):
        """Re-align the mirror with the target after verification:
        ``chunk[j]`` is the token at absolute position ``base_pos + j``;
        the target now stands at ``pos_t`` with ``last_token`` pending.
        Rolls the draft back past rejected positions, or fills positions
        it never wrote (full acceptance ran past the draft's own k)."""
        eng = self.engine
        with self._lock:
            st = eng.states.get(sid)
            if st is None:
                return
            if st.pos < base_pos or pos_t < base_pos or \
                    pos_t > base_pos + len(chunk):
                # mirror drifted out of the chunk's coverage — rebuild
                # lazily from scratch rather than guessing
                self._drop(sid)
                return
            if st.pos < pos_t:
                fill = chunk[st.pos - base_pos: pos_t - base_pos]
                try:
                    eng.prefill_batch([(st, list(fill))])
                except Exception:  # noqa: BLE001
                    self._drop(sid)
                    return
            st.pos = pos_t
            st.last_token = int(last_token)
            eng.spec_rollback(st)

    def release(self, sid: str):
        with self._lock:
            self._drop(sid)


class SpeculativeDecoder:
    """Pairs a target ``LLMEngine`` with a drafter; owns the
    draft → verify → accept → rollback iteration for both decode paths
    (run-to-completion ``decode_batch`` and the continuous decode loop's
    per-iteration ``decode_iteration``).

    Per iteration and per sequence: draft k tokens, run ONE target
    forward over the (k+1)-token chunk ``[last_token, d1..dk]``
    (``spec_verify``), accept the longest prefix with
    ``d_i == argmax(logits[i-1])``, emit those plus the bonus token
    ``argmax(logits[a])``, advance ``pos`` by the emission only, and trim
    paged overshoot blocks. Stats track target steps vs tokens emitted —
    the acceptance length and steps-per-token the benchmark reports."""

    def __init__(self, target, drafter: Optional[EngineDrafter] = None,
                 k: int = 4, max_ngram: int = 3):
        if k < 1:
            raise ValueError(f"speculative draft_k must be >= 1, got {k}")
        self.target = target
        self.k = int(k)
        self.engine_drafter = drafter
        self.lookup = PromptLookupDrafter(max_ngram)
        self._ctx: Dict[str, List[int]] = {}
        self._sid_by_state: Dict[int, str] = {}
        self._ctx_lock = threading.Lock()
        # target_steps/fallback_steps count target-model FORWARDS (one
        # batched verify/decode call each); seq_steps counts per-SEQUENCE
        # step participations, so tokens_emitted / seq_steps is the mean
        # acceptance length per sequence (batch-size independent)
        self.stats = {"target_steps": 0, "fallback_steps": 0,
                      "seq_steps": 0, "tokens_emitted": 0, "drafted": 0,
                      "accepted": 0}
        self._slock = threading.Lock()

    # -- bookkeeping hooks (called by the target engine) --------------------
    # _ctx invariant: the sid's INPUT-token stream including the pending
    # next input (st.last_token — emitted by the head but not yet fed
    # back). _commit keeps it: the last accepted token IS the new
    # pending input, so extending with `emit` preserves the invariant
    # without ever duplicating the tail token in the lookup corpus.
    def note_prefill(self, sid: str, prefix_tokens: List[int],
                     tokens: List[int]):
        """Record a target prefill: extend the sid's token context (used
        by prompt lookup) and mirror it on the draft engine."""
        st = self.target.states.get(sid)
        with self._ctx_lock:
            ctx = self._ctx.setdefault(sid, [])
            fresh = not ctx
            if ctx:
                # a continuation prefill overwrites the position the old
                # pending prediction would have occupied — drop it, as
                # the engine does
                ctx.pop()
            new = (list(prefix_tokens) if fresh else []) + list(tokens)
            ctx.extend(new)
            if st is not None:
                ctx.append(int(st.last_token))
                self._sid_by_state[id(st)] = sid
        if self.engine_drafter is not None and st is not None:
            self.engine_drafter.extend(sid, new, st.last_token)

    def release(self, sid: str):
        with self._ctx_lock:
            self._ctx.pop(sid, None)
            self._sid_by_state = {i: s for i, s in
                                  self._sid_by_state.items() if s != sid}
        if self.engine_drafter is not None:
            self.engine_drafter.release(sid)

    # -- migration (disaggregated prefill/decode handoff) -------------------
    def export_ctx(self, sid: str) -> Optional[List[int]]:
        """Snapshot the sid's prompt-lookup context for migration to
        another replica's SpeculativeDecoder. None when untracked —
        drafting from an empty context is token-identical-safe (greedy
        acceptance never depends on draft quality), just less effective."""
        with self._ctx_lock:
            ctx = self._ctx.get(sid)
            return list(ctx) if ctx else None

    def import_ctx(self, sid: str, ctx: List[int], state):
        """Adopt a migrated sid's context (the _ctx invariant travels
        intact: the source exported its input stream INCLUDING the
        pending next input) and bind it to the sequence's state object
        on THIS engine. The draft-engine mirror is NOT transferred —
        ``EngineDrafter.propose`` falls back to prompt lookup for
        unmirrored sids."""
        with self._ctx_lock:
            self._ctx[sid] = list(ctx)
            self._sid_by_state[id(state)] = sid

    # -- draft/accept core --------------------------------------------------
    def _propose(self, sid: Optional[str], last_token: int) -> List[int]:
        drafts = None
        if self.engine_drafter is not None and sid is not None:
            drafts = self.engine_drafter.propose(sid, self.k)
        if drafts is None:
            with self._ctx_lock:
                ctx = list(self._ctx.get(sid, ()))
            if not ctx:          # unknown sid: only the pending token
                ctx = [int(last_token)]
            drafts = self.lookup.propose(ctx, self.k)
        with self._slock:
            self.stats["drafted"] += self.k
        return drafts

    @staticmethod
    def _accept(drafts: List[int], preds) -> List[int]:
        """Longest greedy-matching prefix + the bonus token: exactly the
        tokens baseline greedy decode would emit."""
        a = 0
        while a < len(drafts) and int(preds[a]) == drafts[a]:
            a += 1
        return drafts[:a] + [int(preds[a])]

    def _commit(self, st, sid: Optional[str], chunk: List[int],
                emit: List[int], loop_sid: Optional[str] = None):
        base_pos = st.pos
        st.pos += len(emit)
        st.last_token = emit[-1]
        self.target.spec_rollback(st, sid=loop_sid)
        with self._ctx_lock:
            if sid in self._ctx:
                self._ctx[sid].extend(emit)
        if self.engine_drafter is not None and sid is not None:
            self.engine_drafter.sync(sid, base_pos, chunk, st.pos,
                                     st.last_token)
        with self._slock:
            self.stats["tokens_emitted"] += len(emit)
            self.stats["accepted"] += len(emit) - 1

    def _sid_of(self, st) -> Optional[str]:
        with self._ctx_lock:
            return self._sid_by_state.get(id(st))

    # -- run-to-completion path (decode_batch / op_decode) ------------------
    def decode_batch(self, items, on_chunk=None):
        """Speculative replacement for ``LLMEngine.decode_batch``: same
        contract (items = [(state, n)], greedy, returns n tokens per item,
        state advanced by n), fewer target forwards. ``on_chunk`` fires
        with cumulative token ids whenever a sequence grows."""
        eng = self.target
        outs: List[List[int]] = [[] for _ in items]
        spec_tokens = 0              # fallback rounds count their own
        while True:
            live = [i for i, (st, n) in enumerate(items)
                    if len(outs[i]) < n]
            if not live:
                break
            spec = [i for i in live
                    if items[i][0].pos + self.k + 1 <= eng.max_len]
            rest = [i for i in live if i not in spec]
            if spec:
                chunks = []
                for i in spec:
                    st = items[i][0]
                    drafts = self._propose(self._sid_of(st), st.last_token)
                    chunks.append((st, [int(st.last_token)] + drafts))
                preds = eng.spec_verify(chunks)
                with self._slock:
                    self.stats["target_steps"] += 1
                    self.stats["seq_steps"] += len(spec)
                for i, (st, chunk), pr in zip(spec, chunks, preds):
                    emit = self._accept(chunk[1:], pr)
                    emit = emit[: items[i][1] - len(outs[i])]
                    self._commit(st, self._sid_of(st), chunk, emit)
                    outs[i].extend(emit)
                    spec_tokens += len(emit)
            if rest:
                # no room for a k+1 chunk before max_len: plain one-token
                # steps through the legacy batch path
                prev_last = [int(items[i][0].last_token) for i in rest]
                res = eng._decode_batch_base([(items[i][0], 1)
                                              for i in rest])
                with self._slock:
                    self.stats["fallback_steps"] += 1
                    self.stats["seq_steps"] += len(rest)
                    self.stats["tokens_emitted"] += len(rest)
                for i, lt, r in zip(rest, prev_last, res):
                    st = items[i][0]
                    sid = self._sid_of(st)
                    with self._ctx_lock:
                        if sid in self._ctx:
                            self._ctx[sid].extend(r)
                    if self.engine_drafter is not None and sid is not None:
                        self.engine_drafter.sync(sid, st.pos - 1, [lt],
                                                 st.pos, st.last_token)
                    outs[i].extend(r)
            if on_chunk is not None:
                for i in live:
                    on_chunk(i, outs[i][: items[i][1]])
        with eng._stats_lock:
            # fallback rounds went through _decode_batch_base, which
            # already counted their tokens
            eng.stats["decode_tokens"] += spec_tokens
            eng.stats["calls"] += 1
        return outs

    # -- continuous decode loop path ----------------------------------------
    def decode_iteration(self, seqs):
        """One loop pass: verify a drafted chunk for every sequence that
        can take one (>= k+1 tokens of remaining budget — paged admission
        reservations cover exactly the sequence's budget horizon — and
        k+1 slots of physical max_len room); everything else advances one
        token through the legacy iteration. A sequence only ever moves
        spec -> fallback (remaining budget shrinks monotonically), so the
        dense path's persistent batch cache stays coherent."""
        eng = self.target
        k = self.k
        spec, rest = [], []
        for r in seqs:
            remaining = r.n - len(r.tokens)
            if remaining >= k + 1 and r.state.pos + k + 1 <= eng.max_len:
                spec.append(r)
            else:
                rest.append(r)
        if rest:
            eng._decode_iteration_base(rest)
            with self._slock:
                self.stats["fallback_steps"] += 1
                self.stats["seq_steps"] += len(rest)
                self.stats["tokens_emitted"] += len(rest)
        if not spec:
            return
        chunks = []
        for r in spec:
            drafts = self._propose(r.sid, r.state.last_token)
            chunks.append((r.state, [int(r.state.last_token)] + drafts))
        preds = eng.spec_verify(chunks, loop_sids=[r.sid for r in spec])
        with self._slock:
            self.stats["target_steps"] += 1
            self.stats["seq_steps"] += len(spec)
        emitted = 0
        for r, (st, chunk), pr in zip(spec, chunks, preds):
            emit = self._accept(chunk[1:], pr)
            emit = emit[: r.n - len(r.tokens)]
            self._commit(st, r.sid, chunk, emit, loop_sid=r.sid)
            r.tokens.extend(emit)
            eng.meter.advance(r.sid, len(emit))
            emitted += len(emit)
        with eng._stats_lock:
            eng.stats["decode_tokens"] += emitted
            eng.stats["decode_iters"] += 1


def attach_speculative(engines: Dict, *, target: str = "core_llm",
                       draft: Optional[str] = "lite_llm", k: int = 4):
    """Enable draft–verify speculative decoding on every replica of the
    target engine/pool. ``draft=None`` uses the model-free prompt-lookup
    drafter; otherwise draft replicas are paired index-aligned with
    target replicas (``engine_pool.pair_replicas``) so each target
    replica drafts on its co-located draft replica."""
    from repro_torch.core.engine_pool import pair_replicas, replicas_of
    tgt = engines[target]
    if draft is None:
        for rep in replicas_of(tgt):
            rep.enable_speculative(draft=None, k=k)
    else:
        for t_rep, d_rep in pair_replicas(tgt, engines[draft]):
            t_rep.enable_speculative(draft=d_rep, k=k)
    return [rep.spec for rep in replicas_of(tgt)]
