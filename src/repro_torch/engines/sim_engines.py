"""Simulation-profile engines (a copy of ``repro/engines/sim_engines.py``;
they run no tensor): same op_ interface as the real engines, but
execution time comes from latency models CALIBRATED TO THE PAPER'S OWN
MEASUREMENTS (NVIDIA 3090-class GPUs), served by sleeping threads.

Why this exists: this container is a 2-core CPU — real tiny-model engines
are *compute-bound at batch size 1*, so GPU-style batching/parallelization
gains (the paper's entire premise: Fig. 4's 1.3x from batch 4->16, true
inter-engine concurrency) cannot manifest in wall-clock there. The
orchestration layer under test is identical — schedulers cannot tell a
profiled engine from a real one. This is the standard methodology for
evaluating schedulers without the paper's testbed; DESIGN.md §2 records
it, and tests validate the real-compute path for correctness separately.

Calibration anchors (paper):
  Fig 4a: embedding 48 reqs: batch 4 -> 1.8 s, batch 16 -> 1.35 s
          => t_embed(b) ~= 50 + 25*b ms per call
  Table 3: single prefill 1000/1700/3000 tok = 260/414/720 ms
          => t_prefill ~= 20 + 0.235 ms/token (per seq, + batch discount)
  Fig 7:  512-tok prefill 0.5 s; batch of two 0.8 s  (0.78 batch factor)
  decode: ~25 ms/step (13B, 2x3090), +2 ms/step per extra seq in batch
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict

import numpy as np

from repro_torch.engines.decode_loop import (DecodeLoopMixin, DecodeSeq,
                                             PrefillJob)
from repro_torch.engines.model_free import ChunkerEngine, SearchAPIEngine, \
    VectorDBEngine

SPEED = float(__import__("os").environ.get("REPRO_SIM_SPEED", "8.0"))
# SPEED scales all modeled latencies down so benchmark sweeps finish in
# container time; it divides every scheme equally (ratios are preserved).


def _sleep(ms: float):
    time.sleep(ms / 1000.0 / SPEED)


def _hvec(text: str, dim: int = 64) -> np.ndarray:
    """Deterministic bag-of-words hash embedding (retrieval-meaningful)."""
    v = np.zeros(dim, np.float32)
    for w in text.split():
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:8], "little")
        v[h % dim] += 1.0 + (h >> 32) % 7 / 7.0
    n = np.linalg.norm(v)
    return v / (n + 1e-9)


def _ptext(seed: str, n: int) -> str:
    h = hashlib.md5(seed.encode()).hexdigest()
    return " ".join(f"w{h[i % 28]}{i}" for i in range(n))


class SimLLMEngine(DecodeLoopMixin):
    kind = "llm"

    def __init__(self, name: str, *, max_batch: int = 8,
                 prefill_ms_per_tok: float = 0.235, prefill_setup: float = 20,
                 decode_ms_per_step: float = 25.0,
                 decode_ms_per_extra_seq: float = 2.0,
                 batch_factor: float = 0.78, stream_chunk: int = 4,
                 paged: bool = False, block_size: int = 16,
                 num_blocks: int = 0, speculative: bool = False,
                 draft_k: int = 4, spec_accept: float = 0.7,
                 spec_draft_cost: float = 0.25,
                 chunked_prefill: bool = False, prefill_chunk: int = 128,
                 token_budget=None, prefix_cache: str = "none",
                 migrate_ms_per_block: float = 0.02):
        self.name = name
        self.max_batch = max_batch
        # disaggregated-handoff ACCOUNTING: import_seq charges
        # migrate_ms_per_block per block-quantized resident block — the
        # PCIe/NVLink-class staging copy the real engine pays in
        # migrate_blocks — so scheduler studies see the handoff on the
        # dispatch critical path exactly where the real runtime puts it.
        self.migrate_ms_per_block = migrate_ms_per_block
        # radix prefix-cache ACCOUNTING: with prefix_cache="radix" a
        # fresh prompt's longest block-aligned word prefix already seen
        # by this replica is "cached" — its tokens are skipped from the
        # modeled prefill cost (capped at len-1: one token always
        # prefills, like the real engine) and every block-aligned prefix
        # of the prompt is remembered. The chunk set is prefix-closed,
        # so its size equals the real tree's node-block count; kv_blocks
        # counts it once (shared prefixes are deduplicated capacity).
        if prefix_cache not in ("none", "radix"):
            raise ValueError(
                f"prefix_cache must be 'none' or 'radix', got "
                f"{prefix_cache!r}")
        if prefix_cache == "radix" and not paged:
            raise ValueError(
                "prefix_cache='radix' requires paged=True")
        self.prefix_cache_mode = prefix_cache
        self._radix_chunks: set = set()
        # chunked-prefill ACCOUNTING: prompts queued via submit_prefill
        # advance prefill_chunk tokens per mixed loop pass, each pass
        # paying the per-call setup plus per-token cost the monolithic
        # prefill formula charges — scheduler simulations see both the
        # bounded decode time-between-tokens AND the decomposition
        # overhead (Table 3) the real engine pays. Decoded text is
        # unchanged (pos advances to the same place before any decode).
        self.chunked_prefill = chunked_prefill
        self.prefill_chunk = int(prefill_chunk)
        self.token_budget = token_budget
        # speculative step ACCOUNTING: with `speculative` on, each target
        # step carries draft_k draft-model steps (each spec_draft_cost of
        # a target step — the lite/core latency ratio) and emits
        # mean_accept_len tokens (expected accepted prefix + bonus under
        # per-token acceptance rate spec_accept), so scheduler
        # simulations see the same target-steps-per-token reduction the
        # real SpeculativeDecoder delivers. Decoded TEXT is unchanged.
        self.speculative = speculative
        self.draft_k = draft_k
        self.spec_accept = spec_accept
        self.spec_draft_cost = spec_draft_cost
        # paged-KV ACCOUNTING (the sim models latency, not tensors): load
        # is reported in allocated blocks — block-quantized resident
        # tokens with shared instruction prefixes counted once — matching
        # the real engine's block-based occupancy. num_blocks>0 also
        # enables kv_free_blocks() for router backpressure.
        self.paged = paged
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.pf_tok = prefill_ms_per_tok
        self.pf_setup = prefill_setup
        self.dec_step = decode_ms_per_step
        self.dec_extra = decode_ms_per_extra_seq
        self.bf = batch_factor
        self.stream_chunk = stream_chunk
        self.states: Dict[str, dict] = {}
        self.prefix_cache: Dict[str, dict] = {}
        self.use_prefix_cache = False      # enabled by LlamaDistPC
        self._lock = threading.Lock()
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0, "calls": 0,
                      "decode_iters": 0, "busy_ms": 0.0,
                      "radix_hit_tokens": 0,
                      "migrations_in": 0, "migrated_blocks": 0}
        self._stats_lock = threading.Lock()
        self._decode_loop = None
        # fault tolerance: injector hook + replica health (see LLMEngine)
        self.faults = None
        self.health = "healthy"
        # SLO scheduling policy (attached per replica by slo.attach_slo;
        # None keeps every scheduling path byte-identical)
        self.slo = None

    def _fault(self, point: str):
        inj = self.faults
        if inj is not None:
            inj.fire(self, point)

    def clone(self, idx: int = 1) -> "SimLLMEngine":
        """Pool replica: same latency profile and SHARED instruction-prefix
        cache (weights-equivalent), PER-REPLICA sequence store and stats."""
        c = SimLLMEngine(
            f"{self.name}.r{idx}", max_batch=self.max_batch,
            prefill_ms_per_tok=self.pf_tok, prefill_setup=self.pf_setup,
            decode_ms_per_step=self.dec_step,
            decode_ms_per_extra_seq=self.dec_extra, batch_factor=self.bf,
            stream_chunk=self.stream_chunk, paged=self.paged,
            block_size=self.block_size, num_blocks=self.num_blocks,
            speculative=self.speculative, draft_k=self.draft_k,
            spec_accept=self.spec_accept,
            spec_draft_cost=self.spec_draft_cost,
            chunked_prefill=self.chunked_prefill,
            prefill_chunk=self.prefill_chunk,
            token_budget=self.token_budget,
            prefix_cache=self.prefix_cache_mode,
            migrate_ms_per_block=self.migrate_ms_per_block)
        c.prefix_cache = self.prefix_cache
        c.use_prefix_cache = self.use_prefix_cache
        return c

    # -- sequence migration (disaggregated prefill/decode handoff) ----------
    def export_seq(self, sid: str) -> dict:
        """Sim form of ``LLMEngine.export_seq``: snapshot the sequence
        for adoption by another replica. The state stays resident here
        until the import lands."""
        job = None
        loop = self._decode_loop
        if loop is not None and loop.is_alive():
            job = loop.detach_prefill(sid)
        with self._lock:
            st = self.states[sid]
        return {"sid": sid, "engine": self, "state": st,
                "paged": self.paged, "block_size": self.block_size,
                "job": job}

    def import_seq(self, handle):
        """Sim form of ``LLMEngine.import_seq``: adopt the sequence and
        charge the modeled block-transfer cost (the staging copy of
        ``migrate_blocks``) on the CALLER's thread — the scheduler pays
        it, the destination decode loop keeps iterating. Returns the
        continuation PrefillJob for a mid-flight prompt, else None."""
        self._fault("migrate")
        src, sid = handle["engine"], handle["sid"]
        st = handle["state"]
        job = handle.get("job")
        if src is self:
            if job is not None and job.remaining() \
                    and not job.done.is_set():
                return self.start_decode_loop().submit_prefill(job)
            return None
        blocks = -(-st.get("pos", 0) // self.block_size)
        _sleep(self.migrate_ms_per_block * blocks)
        with self._lock:
            new_st = dict(st)
            self.states[sid] = new_st
        src.release(sid)
        with self._stats_lock:
            self.stats["migrations_in"] += 1
            self.stats["migrated_blocks"] += blocks
        if job is not None and job.remaining() and not job.done.is_set():
            pending = job.tokens[job.cursor:]

            def _done(cont):
                job.t_done = time.time()
                job.error = cont.error
                job.done.set()

            cont = PrefillJob(sid, new_st, pending, on_done=_done,
                              ptoks=job.ptoks)
            return self.start_decode_loop().submit_prefill(cont)
        return None

    def mean_accept_len(self) -> float:
        """Expected tokens emitted per target verification step: the
        accepted draft prefix (geometric under per-token rate p) plus
        the bonus token — 1 + p + p^2 + ... + p^k."""
        return 1.0 + sum(self.spec_accept ** i
                         for i in range(1, self.draft_k + 1))

    def _spec_step_ms(self, b: int) -> float:
        """Modeled cost of ONE speculative iteration at batch size b:
        the target verify forward plus draft_k draft-model steps."""
        return (self.dec_step * (1.0 + self.draft_k * self.spec_draft_cost)
                + self.dec_extra * (b - 1))

    def kv_blocks(self) -> int:
        """Allocated-block count: per-sequence positions block-quantized,
        plus the shared instruction prefixes ONCE (their tokens are
        excluded from forked sequences' pos by op_prefill). In radix
        mode the tree's chunk set IS the shared capacity (each member is
        one cached block); sequences count only their uncached tails."""
        bs = self.block_size
        with self._lock:
            if self.prefix_cache_mode == "radix":
                # pos already excludes skipped (cached) prefix tokens —
                # each sequence contributes only its uncached tail
                blocks = sum(-(-st.get("pos", 0) // bs)
                             for st in self.states.values())
                return blocks + len(self._radix_chunks)
            blocks = sum(-(-st.get("pos", 0) // bs)
                         for st in self.states.values())
            blocks += sum(-(-st.get("pos", 0) // bs)
                          for st in self.prefix_cache.values())
        return blocks

    def kv_free_blocks(self):
        """Free pool blocks (None when no pool bound — dense accounting
        or unbounded sim)."""
        if not self.paged or not self.num_blocks:
            return None
        return max(0, self.num_blocks - self.kv_blocks())

    def kv_occupancy(self) -> int:
        """Resident KV tokens on this replica (pool-router load input).
        Paged accounting reports block-quantized true memory."""
        if self.paged:
            return self.kv_blocks() * self.block_size
        with self._lock:
            return sum(st.get("pos", 0) for st in self.states.values())

    def _ntok(self, text: str) -> int:
        return max(1, len(text.split()))

    def _radix_match_locked(self, words) -> int:
        """Longest cached block-aligned word prefix, capped at len-1
        (self._lock held). Returns matched word count."""
        bs = self.block_size
        kmax = max(0, (len(words) - 1)) // bs
        m = 0
        for k in range(1, kmax + 1):
            if tuple(words[:k * bs]) in self._radix_chunks:
                m = k * bs
            else:
                break
        return m

    def _radix_insert_locked(self, words):
        """Remember every block-aligned prefix of ``words`` (the modeled
        insert: one set member per cached tree block)."""
        bs = self.block_size
        for k in range(1, len(words) // bs + 1):
            self._radix_chunks.add(tuple(words[:k * bs]))

    def _prefill_task_len(self, t) -> tuple:
        """(state, effective prompt tokens) for one prefill task —
        instruction-prefix reuse skips cached prefix tokens exactly like
        the batch path; radix mode generalizes the skip to ANY cached
        block-aligned prompt prefix and remembers this prompt's."""
        text = t["text"]
        n = self._ntok(text)
        m = 0
        with self._lock:
            fresh = t["sid"] not in self.states
            st = self.states.setdefault(t["sid"], {"pos": 0})
            if fresh and self.prefix_cache_mode == "radix":
                words = text.split() or [text]
                m = self._radix_match_locked(words)
                self._radix_insert_locked(words)
                if m:
                    n = max(1, n - m)
            elif fresh and self.use_prefix_cache:
                # instruction-prefix KV reuse: skip cached prefix tokens
                for instr in self.prefix_cache:
                    if text.startswith(instr):
                        n = max(1, n - self._ntok(instr))
                        break
        if m:
            with self._stats_lock:
                self.stats["radix_hit_tokens"] += m
        return st, n

    def op_prefill(self, tasks):
        self._fault("prefill")
        if self.chunked_prefill:
            # stream every prompt through the loop's prefill queue (the
            # scheduler thread blocks; co-resident decodes keep ticking)
            jobs = [self.submit_prefill(t) for t in tasks]
            for job in jobs:
                job.wait(300)
            return [None] * len(tasks)
        toks = []
        for t in tasks:
            st, n = self._prefill_task_len(t)
            st["pos"] = st.get("pos", 0) + n
            toks.append(n)
        b = len(tasks)
        dur = self.pf_setup + self.pf_tok * sum(toks) * \
            (self.bf if b > 1 else 1.0)
        _sleep(dur)
        with self._stats_lock:
            self.stats["prefill_tokens"] += sum(toks)
            self.stats["calls"] += 1
            self.stats["busy_ms"] += dur
        return [None] * b

    def submit_prefill(self, task, on_done=None) -> PrefillJob:
        """Chunked-prefill admission into the continuous loop (sim form
        of ``LLMEngine.submit_prefill``): the job's cursor advances
        prefill_chunk tokens per mixed pass with modeled chunk cost."""
        if not self.chunked_prefill:
            raise RuntimeError(f"{self.name}: chunked_prefill is disabled")
        st, n = self._prefill_task_len(task)
        job = PrefillJob(task["sid"], st, list(range(n)), on_done=on_done,
                         slo=task.get("slo"))
        return self.start_decode_loop().submit_prefill(job)

    def decode_token_cost(self, seqs) -> int:
        """Loop token-budget input: speculative passes carry k+1 query
        tokens per sequence, plain passes one."""
        return len(seqs) * (self.draft_k + 1 if self.speculative else 1)

    def mixed_iteration(self, seqs, pitems):
        """One mixed pass: the resident decode batch advances first,
        then the pass's prefill chunks land with the monolithic-prefill
        cost formula applied per pass (per-call setup + per-token cost —
        the decomposition overhead Table 3 measures)."""
        if seqs:
            self.decode_iteration(seqs)
        if not pitems:
            return
        self._fault("prefill")
        ntok = sum(n for _, n in pitems)
        dur = self.pf_setup + self.pf_tok * ntok * \
            (self.bf if len(pitems) > 1 else 1.0)
        _sleep(dur)
        for job, n in pitems:
            job.state["pos"] = job.state.get("pos", 0) + n
            job.cursor += n
        with self._stats_lock:
            self.stats["prefill_tokens"] += ntok
            self.stats["calls"] += 1
            self.stats["busy_ms"] += dur

    def op_decode(self, tasks, on_chunk=None):
        self._fault("decode")
        n_max = max(int(t["max_new"]) for t in tasks)
        b = len(tasks)
        if self.speculative:
            # ceil(n / mean_accept_len) target steps, each carrying the
            # draft cost — the run-to-completion speculative latency
            steps = int(np.ceil(n_max / self.mean_accept_len()))
            dur = steps * self._spec_step_ms(b)
        else:
            dur = n_max * (self.dec_step + self.dec_extra * (b - 1))
        if on_chunk is None:
            _sleep(dur)
            out = []
            for t in tasks:
                st = self.states.setdefault(t["sid"], {"pos": 0})
                st["pos"] += int(t["max_new"])
                out.append(_ptext(t["sid"] + str(st["pos"]),
                                  int(t["max_new"])))
        else:
            # streaming: the final text is determined up front (the sim has
            # no real sampling); the modeled decode time is spent in
            # per-chunk slices, each emitting the words "decoded" so far
            out, words = [], []
            for t in tasks:
                st = self.states.setdefault(t["sid"], {"pos": 0})
                st["pos"] += int(t["max_new"])
                text = _ptext(t["sid"] + str(st["pos"]), int(t["max_new"]))
                out.append(text)
                words.append(text.split())
            step = 0
            while step < n_max:
                nsteps = min(self.stream_chunk, n_max - step)
                _sleep(dur * nsteps / n_max)
                step += nsteps
                for i, t in enumerate(tasks):
                    m = min(step, int(t["max_new"]))
                    if m > 0:
                        on_chunk(i, " ".join(words[i][:m]))
        with self._stats_lock:
            self.stats["decode_tokens"] += sum(int(t["max_new"])
                                               for t in tasks)
            self.stats["calls"] += 1
            self.stats["busy_ms"] += dur
        return out

    # -- iteration-level continuous batching --------------------------------
    # (loop lifecycle — start/stop/slots — comes from DecodeLoopMixin)
    def submit_decode(self, sid: str, max_new: int, on_text=None,
                      on_done=None, slo=None) -> DecodeSeq:
        """Admit `sid` into the continuous decode loop. The sim has no
        real sampling, so the final text is fixed at submit time exactly
        as the legacy path fixes it (same state/pos advance — continuous
        and run-to-completion decode produce identical text); the modeled
        decode TIME is spent iteration by iteration with per-iteration
        word release."""
        max_new = int(max_new)
        with self._lock:
            st = self.states.setdefault(sid, {"pos": 0})
            st["pos"] += max_new
            text = _ptext(sid + str(st["pos"]), max_new)
        seq = DecodeSeq(sid, st, max_new,
                        text_fn=lambda s: " ".join(s.tokens),
                        on_text=on_text, on_done=on_done, slo=slo)
        seq.words = text.split()
        return self.start_decode_loop().submit(seq)

    # -- SLO preemption (sim form): the output words are fixed at submit
    # time, so evict-to-recompute only has to model the MEMORY release
    # and the replay cost — token identity is free by construction.
    def can_preempt(self, seq) -> bool:
        return True

    def preempt_decode(self, seq):
        """Free the sequence's modeled KV (pos → 0 releases its blocks
        from kv_blocks/kv_free_blocks accounting); the loop re-queues
        the DecodeSeq with its emitted words intact."""
        with self._lock:
            seq._slo_saved_pos = seq.state.get("pos", 0)
            seq.state["pos"] = 0
        seq.slo_preempted = True

    def _slo_resume(self, seq):
        """Charge the replay prefill (recorded prompt + emitted tokens —
        what the real engine re-prefills) and restore the position."""
        seq.slo_preempted = False
        with self._lock:
            seq.state["pos"] = getattr(seq, "_slo_saved_pos", 0)
        # saved pos pre-charged the whole decode; resident at preemption
        # was prompt + steps
        replay = max(1, getattr(seq, "_slo_saved_pos", seq.n)
                     - seq.n + seq.steps)
        dur = self.pf_setup + self.pf_tok * replay
        _sleep(dur)
        with self._stats_lock:
            self.stats["prefill_tokens"] += replay
            self.stats["calls"] += 1
            self.stats["busy_ms"] += dur

    def tenant_stats(self) -> dict:
        """Per-(tenant, class) scheduling stats (empty unless armed)."""
        return self.slo.tenant_stats() if self.slo is not None else {}

    def recover_decode(self, sid: str, text: str, max_new: int,
                       failed=None, on_text=None, on_done=None,
                       slo=None) -> DecodeSeq:
        """Sim form of ``LLMEngine.recover_decode``: replay a sequence
        lost on a dead replica. The replay prefill's modeled cost is
        charged on the caller's thread (recovery latency is visible to
        scheduler studies); the dead replica's fixed output words are
        REUSED when its DecodeSeq handle survives — the sim's text
        depends on submit-time state, so regenerating it here would not
        be output-identical — and only the remaining words' decode time
        is spent."""
        max_new = int(max_new)
        self.release(sid)
        st, n = self._prefill_task_len({"sid": sid, "text": text})
        dur = self.pf_setup + self.pf_tok * n
        _sleep(dur)
        with self._lock:
            st["pos"] = st.get("pos", 0) + n + max_new
            if failed is not None and getattr(failed, "words", None):
                words = list(failed.words)
            else:
                words = _ptext(sid + str(st["pos"]), max_new).split()
        with self._stats_lock:
            self.stats["prefill_tokens"] += n
            self.stats["calls"] += 1
            self.stats["busy_ms"] += dur
        seq = DecodeSeq(sid, st, max_new,
                        text_fn=lambda s: " ".join(s.tokens),
                        on_text=on_text, on_done=on_done, slo=slo)
        seq.words = words
        emitted = list(getattr(failed, "tokens", [])) if failed is not None \
            else []
        seq.tokens = emitted[:max_new]
        seq.steps = len(seq.tokens)
        if seq.steps >= seq.n:
            seq.result = " ".join(seq.tokens)
            seq.t_done = time.time()
            seq.done.set()
            if on_done is not None:
                on_done(seq)
            return seq
        return self.start_decode_loop().submit(seq)

    def decode_iteration(self, seqs):
        """One modeled decode step for the resident batch: per-iteration
        latency depends on the CURRENT batch size (the iteration-level
        analogue of the legacy per-batch formula). In speculative mode
        the step carries the draft cost and releases mean_accept_len
        tokens per sequence (error-diffused to integers so long runs hit
        the mean exactly) — the loop advances each sequence by the
        emitted count, exactly like the real SpeculativeDecoder."""
        self._fault("decode")
        if self.slo is not None:
            for r in seqs:
                if getattr(r, "slo_preempted", False):
                    self._slo_resume(r)
        b = len(seqs)
        emitted = 0
        if self.speculative:
            dur = self._spec_step_ms(b)
            _sleep(dur)
            for r in seqs:
                carry = getattr(r, "spec_carry", 0.0) + self.mean_accept_len()
                emit = max(1, int(carry))
                r.spec_carry = carry - emit
                for _ in range(emit):
                    if len(r.tokens) < len(r.words):
                        r.tokens.append(r.words[len(r.tokens)])
                        emitted += 1
        else:
            dur = self.dec_step + self.dec_extra * (b - 1)
            _sleep(dur)
            for r in seqs:
                if len(r.tokens) < len(r.words):
                    r.tokens.append(r.words[len(r.tokens)])
            emitted = b
        with self._stats_lock:
            self.stats["decode_tokens"] += emitted
            self.stats["decode_iters"] += 1
            self.stats["busy_ms"] += dur

    def prefix_match_len(self, text: str) -> int:
        """Longest radix-cached word prefix of ``text`` (0 without the
        radix cache) — the pool router's prefix-affinity probe."""
        if self.prefix_cache_mode != "radix":
            return 0
        words = text.split() or [text]
        with self._lock:
            return self._radix_match_locked(words)

    def get_prefix_state(self, instruction: str):
        with self._lock:
            st = self.prefix_cache.get(instruction)
            if st is None:
                st = {"pos": self._ntok(instruction)}
                self.prefix_cache[instruction] = st
            if self.prefix_cache_mode == "radix":
                # warmup seeds the modeled tree too (cold/warm replica
                # symmetry, like the real engine)
                self._radix_insert_locked(instruction.split()
                                          or [instruction])
        return st

    def release(self, sid: str):
        with self._lock:
            self.states.pop(sid, None)


class SimEmbeddingEngine:
    kind = "embedding"

    def __init__(self, name="embedding", max_batch: int = 16,
                 setup_ms: float = 50.0, per_req_ms: float = 25.0):
        self.name = name
        self.max_batch = max_batch
        self.setup = setup_ms
        self.per_req = per_req_ms
        self.stats = {"requests": 0, "calls": 0, "busy_ms": 0.0}
        # fault tolerance / overload: injector hook + replica health so
        # pooled encoders participate in burst studies and hedging
        self.faults = None
        self.health = "healthy"

    def _fault(self, point: str):
        inj = self.faults
        if inj is not None:
            inj.fire(self, point)

    def clone(self, idx: int = 1) -> "SimEmbeddingEngine":
        return SimEmbeddingEngine(f"{self.name}.r{idx}", self.max_batch,
                                  self.setup, self.per_req)

    def op_embed(self, tasks):
        self._fault("encode")
        n = sum(len(t["texts"]) for t in tasks)
        # setup cost per underlying model call (ceil(n/max_batch) calls)
        dur = self.setup * max(1, -(-n // self.max_batch)) + self.per_req * n
        _sleep(dur)
        out = []
        for t in tasks:
            out.append(np.stack([_hvec(x) for x in t["texts"]])
                       if t["texts"] else np.zeros((0, 64), np.float32))
        self.stats["requests"] += n
        self.stats["calls"] += 1
        self.stats["busy_ms"] += dur
        return out


class SimRerankEngine:
    kind = "rerank"

    def __init__(self, name="rerank", max_batch: int = 16,
                 setup_ms: float = 40.0, per_pair_ms: float = 18.0):
        self.name = name
        self.max_batch = max_batch
        self.setup = setup_ms
        self.per_pair = per_pair_ms
        self.stats = {"requests": 0, "calls": 0, "busy_ms": 0.0}
        self.faults = None
        self.health = "healthy"

    def _fault(self, point: str):
        inj = self.faults
        if inj is not None:
            inj.fire(self, point)

    def clone(self, idx: int = 1) -> "SimRerankEngine":
        return SimRerankEngine(f"{self.name}.r{idx}", self.max_batch,
                               self.setup, self.per_pair)

    def op_rerank(self, tasks):
        self._fault("encode")
        n = sum(len(t["candidates"]) for t in tasks)
        dur = self.setup * max(1, -(-n // self.max_batch)) + self.per_pair * n
        _sleep(dur)
        out = []
        for t in tasks:
            cands = t["candidates"]
            if not cands:
                out.append([])
                continue
            qv = _hvec(t["question"])
            scores = [float(qv @ _hvec(c["text"])) for c in cands]
            order = np.argsort(scores)[::-1][: t.get("top_k", 3)]
            out.append([{**cands[i], "rerank_score": scores[i]}
                        for i in order])
        self.stats["requests"] += n
        self.stats["calls"] += 1
        self.stats["busy_ms"] += dur
        return out


class SimVectorDB(VectorDBEngine):
    def __init__(self, name="vectordb"):
        super().__init__(name, max_batch=64,
                         ingest_latency_per_vec=0.004 / SPEED,
                         search_latency=0.010 / SPEED)


class SimSearchAPI(SearchAPIEngine):
    def __init__(self, name="search_api"):
        super().__init__(name, max_batch=4, latency=0.18 / SPEED)


def build_sim_engines(*, llm_max_batch: int = 8, core_decode_ms: float = 25.0,
                      lite_scale: float = 0.25,
                      llm_instances: int = 1,
                      paged_kv: bool = False,
                      kv_block_size: int = 16,
                      speculative: bool = False,
                      draft_k: int = 4,
                      chunked_prefill: bool = False,
                      prefill_chunk: int = 128,
                      token_budget=None,
                      prefix_cache: str = "none",
                      disaggregate: bool = False,
                      prefill_replicas: int = 1,
                      decode_replicas: int = 1,
                      encoder_instances: int = 1) -> dict:
    """Engine set with paper-calibrated profiles. lite_llm (gemma-2-2B
    contextualizer / llama-7B judge) is ~4x faster than the core LLM.
    llm_instances>1 puts the LLM engines behind EnginePools (the paper's
    testbed provisions two instances per LLM); the pooled lower-tier
    scheduler routes fused batches to the least-loaded replica with
    sequence affinity. ``speculative`` switches the CORE LLM to
    draft-verify step accounting (drafted on the co-located lite profile:
    spec_draft_cost = lite_scale). ``disaggregate`` puts each LLM behind
    a DisaggregatedEnginePool of prefill_replicas prefill specialists +
    decode_replicas decode specialists with modeled KV-handoff cost
    (mutually exclusive with llm_instances > 1). ``encoder_instances>1``
    pools the embedding/rerank encoders too — the substrate hedged
    dispatch needs for backup requests."""
    from repro_torch.core.engine_pool import (DisaggregatedEnginePool,
                                              EnginePool)

    core = SimLLMEngine("core_llm", max_batch=llm_max_batch,
                        decode_ms_per_step=core_decode_ms,
                        paged=paged_kv, block_size=kv_block_size,
                        speculative=speculative, draft_k=draft_k,
                        spec_draft_cost=lite_scale,
                        chunked_prefill=chunked_prefill,
                        prefill_chunk=prefill_chunk,
                        token_budget=token_budget,
                        prefix_cache=prefix_cache)
    lite = SimLLMEngine(
        "lite_llm", max_batch=llm_max_batch * 2,
        prefill_ms_per_tok=0.235 * lite_scale,
        prefill_setup=8,
        decode_ms_per_step=core_decode_ms * lite_scale,
        decode_ms_per_extra_seq=0.5,
        paged=paged_kv, block_size=kv_block_size,
        chunked_prefill=chunked_prefill,
        prefill_chunk=prefill_chunk,
        token_budget=token_budget,
        prefix_cache=prefix_cache)

    if disaggregate:
        if llm_instances > 1:
            raise ValueError(
                "disaggregate and llm_instances > 1 are mutually "
                "exclusive (replica counts come from prefill_replicas/"
                "decode_replicas)")
        core = DisaggregatedEnginePool.disaggregate(
            core, prefill_replicas, decode_replicas, name="core_llm")
        lite = DisaggregatedEnginePool.disaggregate(
            lite, prefill_replicas, decode_replicas, name="lite_llm")
    n = llm_instances
    if n > 1:
        core = EnginePool.replicate(core, n, name="core_llm")
        lite = EnginePool.replicate(lite, n, name="lite_llm")
    embedding = SimEmbeddingEngine()
    rerank = SimRerankEngine()
    if encoder_instances > 1:
        # pooled encoders: the hedged-dispatch substrate (a backup embed/
        # rerank needs a second healthy replica to land on)
        embedding = EnginePool.replicate(embedding, encoder_instances,
                                         name="embedding")
        rerank = EnginePool.replicate(rerank, encoder_instances,
                                      name="rerank")
    return {
        "core_llm": core,
        "lite_llm": lite,
        "embedding": embedding,
        "rerank": rerank,
        "vectordb": SimVectorDB(),
        "chunker": ChunkerEngine(),
        "search_api": SimSearchAPI(),
    }
