"""Iteration-level continuous batching: the persistent decode loop.

Run-to-completion decode batching (the legacy ``decode_batch`` path)
forms a batch once and steps it until the LONGEST member finishes: short
sequences idle in their slots and a sequence arriving one iteration
after batch formation waits an entire batch-time. Teola's timing-aware
batching (§5) — like Orca-style iteration-level scheduling — instead
re-forms the decode batch every iteration.

``ContinuousDecodeLoop`` is that loop, engine-agnostic. Per iteration it

  1. admits waiting sequences into free decode slots (``max_slots``),
  2. advances every resident sequence by ONE token via the engine's
     ``decode_iteration(seqs)``,
  3. emits a per-iteration chunk per sequence (``on_text`` receives the
     cumulative decoded text — the TokenStream emission point),
  4. evicts finished sequences IMMEDIATELY, freeing their slot for the
     next admission pass, and fires their ``on_done``.

CHUNKED PREFILL (Sarathi-style stall-free mixed batches): with
``prefill_chunk > 0`` the loop also owns a PREFILL queue of
``PrefillJob``s — resumable per-sequence prompt cursors. Each pass packs
all resident decode tokens FIRST, then fills the remaining per-pass
``token_budget`` with prefill-chunk tokens, and hands both to the
engine's ``mixed_iteration(seqs, prefill_items)``. A long prompt
therefore advances in bounded chunks BETWEEN decode steps instead of
head-of-line-blocking every co-resident decode for a whole-prompt
forward: decode time-between-tokens is bounded by one chunk's compute,
never by prompt length. Decodes always advance (the budget caps prefill
admission, it never splits the resident decode batch); a pass with no
budget headroom simply carries no prefill tokens.

The engine owns all model state and numerics; the loop owns residency,
slot accounting (mirrored into the engine via the optional
``note_slot_acquired`` / ``note_slot_released`` hooks, which the real
engine forwards to its ``OccupancyMeter``), the prefill token-budget
admission, and completion signaling. Both the real ``LLMEngine`` and
the latency-profile ``SimLLMEngine`` drive the same loop.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional


class DecodeSeq:
    """One sequence's residency in a continuous decode loop.

    ``state`` is an engine-specific handle (the real engine's per-sequence
    KV ``SeqState``, the sim engine's state dict); ``tokens`` is the
    engine-appended output payload (token ids / words); ``text_fn``
    renders it to text for chunk emission and the final ``result``.
    """

    def __init__(self, sid: str, state, n: int, *,
                 text_fn: Callable[["DecodeSeq"], str],
                 on_text: Optional[Callable[[str], None]] = None,
                 on_done: Optional[Callable[["DecodeSeq"], None]] = None,
                 slo=None):
        self.sid = sid
        self.state = state
        self.n = int(n)
        self.text_fn = text_fn
        self.on_text = on_text
        self.on_done = on_done
        # SLO scheduling metadata (serving/slo.SLOTag) — None means
        # untagged; the loop only consults it when the engine has an
        # attached SLOPolicy
        self.slo = slo
        # set by the engine when this sequence was preempted
        # (evict-to-recompute) and must have its KV rebuilt on re-entry
        self.slo_preempted = False
        self.tokens: list = []
        self.steps = 0
        self.result: Optional[str] = None
        self.error: Optional[Exception] = None
        self.done = threading.Event()
        self.t_submit = time.time()
        self.t_admit: Optional[float] = None
        self.t_done: Optional[float] = None

    def wait(self, timeout: float = 300) -> str:
        """Block until eviction; return the final decoded text."""
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"decode {self.sid} not evicted after {timeout}s "
                f"({self.steps}/{self.n} steps)")
        if self.error is not None:
            raise self.error
        return self.result

    def __repr__(self):
        return (f"<DecodeSeq {self.sid} {self.steps}/{self.n} "
                f"done={self.done.is_set()}>")


class PrefillJob:
    """One prompt's resumable residency in the loop's PREFILL queue.

    ``state`` is the engine's per-sequence handle (its ``pos`` is the
    authoritative write cursor); ``tokens`` is the full remaining token
    list to prefill; ``cursor`` counts tokens already consumed by landed
    chunks. The engine's ``mixed_iteration`` advances the cursor chunk
    by chunk; the loop evicts the job (firing ``on_done``) once the
    cursor reaches the end.
    """

    def __init__(self, sid: str, state, tokens: list, *,
                 on_done: Optional[Callable[["PrefillJob"], None]] = None,
                 ptoks: Optional[list] = None, slo=None):
        self.sid = sid
        self.slo = slo
        self.state = state
        self.tokens = list(tokens)
        # tokens already resident when the job was created (radix/COW
        # prefix + earlier turns) — carried so a mid-flight migration can
        # reconstruct the sequence's full token context on the new engine
        self.ptoks = list(ptoks) if ptoks else []
        self.cursor = 0
        self.chunks = 0                     # landed chunk count
        self.on_done = on_done
        self.error: Optional[Exception] = None
        self.done = threading.Event()
        self.t_submit = time.time()
        self.t_progress = time.time()       # last time a chunk landed
        self.t_done: Optional[float] = None

    def remaining(self) -> int:
        return len(self.tokens) - self.cursor

    def wait(self, timeout: float = 300):
        """Block until the whole prompt has been prefilled."""
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"prefill {self.sid} not finished after {timeout}s "
                f"({self.cursor}/{len(self.tokens)} tokens)")
        if self.error is not None:
            raise self.error

    def __repr__(self):
        return (f"<PrefillJob {self.sid} {self.cursor}/{len(self.tokens)} "
                f"done={self.done.is_set()}>")


class ContinuousDecodeLoop(threading.Thread):
    """Persistent decode loop over an engine's decode slots, optionally
    mixing budget-bounded prefill chunks into each pass."""

    def __init__(self, engine, max_slots: int, idle_wait: float = 0.05,
                 admit_timeout: float = 60.0, prefill_chunk: int = 0,
                 token_budget: Optional[int] = None):
        super().__init__(
            daemon=True,
            name=f"decode-loop-{getattr(engine, 'name', '?')}")
        self.engine = engine
        self.max_slots = max(1, int(max_slots))
        self.idle_wait = idle_wait
        # how long a sequence may sit at the queue head with the engine
        # refusing admission (KV backpressure) before it is failed —
        # without this, one unsatisfiable waiter starves every decode
        # submitted after it
        self.admit_timeout = admit_timeout
        # chunked prefill: tokens per prefill chunk (0 disables the
        # prefill queue) and the per-pass token budget shared by decode
        # and prefill tokens. Default budget fits a full decode batch
        # plus one full chunk, so decodes never shrink a chunk and a
        # chunk never starves.
        self.prefill_chunk = max(0, int(prefill_chunk or 0))
        self.token_budget = int(token_budget) if token_budget else \
            (self.prefill_chunk + self.max_slots if self.prefill_chunk
             else 0)
        self.waiting: deque = deque()
        self.prefill_waiting: deque = deque()
        # ids of PrefillJobs whose chunk is inside the currently-executing
        # mixed pass (the engine call runs OUTSIDE the cv) — detach must
        # wait these out before handing the job's state to another engine
        self._inflight_prefill: frozenset = frozenset()
        self.active: List[DecodeSeq] = []
        self.cv = threading.Condition()
        self.running = True
        # fault tolerance: `last_pass` is the loop's heartbeat — updated
        # at the top of every pass, so a pass stuck inside an engine
        # call (hung replica) goes stale and the watchdog can tell a
        # hung loop from an idle one. `fatal_error` captures the first
        # exception that escapes the loop body (loop-thread death must
        # never be silent — the run() wrapper drains every queued
        # sequence with it and marks the engine suspect).
        self.last_pass = time.time()
        self.fatal_error: Optional[Exception] = None
        # introspection (tests / benchmarks)
        self.iterations = 0
        self.max_resident = 0
        self.admissions: List[tuple] = []   # (sid, iteration_admitted)
        self.evictions: List[tuple] = []    # (sid, iteration_evicted, steps)
        self.callback_errors: List[tuple] = []   # (sid, exception)
        self.prefill_chunks: List[tuple] = []    # (sid, iteration, ntokens)
        self.mixed_log: List[tuple] = []    # (decode_cost, prefill_tokens)
        self.preemptions: List[tuple] = []  # (sid, iteration, steps_kept)
        # SLO mode: set by _admit_locked when an urgent (interactive or
        # aged) waiter was deferred this pass — the preemption trigger
        self._slo_deferred_urgent = False

    # -- producer side ------------------------------------------------------
    def submit(self, seq: DecodeSeq) -> DecodeSeq:
        pol = getattr(self.engine, "slo", None)
        if pol is not None:
            pol.stats.bump(pol.tag_of(seq), "submitted")
        with self.cv:
            self.waiting.append(seq)
            self.cv.notify()
        return seq

    def submit_prefill(self, job: PrefillJob) -> PrefillJob:
        """Queue a prompt for chunked prefill inside the loop. Requires
        ``prefill_chunk > 0`` (the engine enables it)."""
        if not self.prefill_chunk:
            raise RuntimeError(
                f"decode loop of {getattr(self.engine, 'name', '?')} has "
                f"chunked prefill disabled (prefill_chunk=0)")
        with self.cv:
            self.prefill_waiting.append(job)
            self.cv.notify()
        return job

    def detach_prefill(self, sid: str) -> Optional[PrefillJob]:
        """Pull ``sid``'s mid-flight PrefillJob out of the loop so its
        sequence can migrate to another engine (disaggregated handoff of
        a partially-prefilled prompt). Removes the job from the queue,
        then waits out any pass currently landing one of its chunks —
        on return the job's cursor/state are final and no loop thread
        will touch them again. Returns None when ``sid`` has no queued
        job (already finished, or never chunk-prefilled). A job that
        FINISHES in the very pass being waited out completes normally on
        this engine (its ``on_done`` fires here); callers see
        ``remaining() == 0`` and skip the continuation."""
        with self.cv:
            job = next((j for j in self.prefill_waiting if j.sid == sid),
                       None)
            if job is None:
                return None
            self.prefill_waiting.remove(job)
            while id(job) in self._inflight_prefill:
                self.cv.wait(timeout=0.05)
        return job

    def slots_free(self) -> int:
        """Slots not claimed by resident or already-queued sequences."""
        with self.cv:
            return max(0, self.max_slots - len(self.active)
                       - len(self.waiting))

    def occupancy(self) -> int:
        with self.cv:
            return len(self.active) + len(self.waiting)

    def stop(self):
        with self.cv:
            self.running = False
            self.cv.notify()
        if threading.current_thread() is not self:
            self.join(timeout=10)

    # -- loop internals -----------------------------------------------------
    def _decode_cost(self, batch) -> int:
        """Query tokens the decode part of this pass will carry (plain
        engines: one per resident sequence; speculative engines report
        k+1 for chunk-eligible sequences via ``decode_token_cost``)."""
        fn = getattr(self.engine, "decode_token_cost", None)
        return int(fn(batch)) if fn is not None else len(batch)

    def _take_prefill_locked(self, decode_cost: int):
        """Token-budget admission: plan prefill chunks for this pass —
        FIFO over the prefill queue, each job contributing at most one
        chunk of min(prefill_chunk, remaining, budget room) tokens.
        Decode tokens are packed first; prefill only ever takes the
        leftover budget (decodes never wait behind a prompt)."""
        if not self.prefill_chunk or not self.prefill_waiting:
            return []
        room = self.token_budget - decode_cost
        items = []
        pol = getattr(self.engine, "slo", None)
        # SLO mode: interactive chunks pack first (per-class FIFO behind
        # that, aging promotes starved batch jobs). A batch PrefillJob
        # skipped while interactive jobs drain the budget is PAUSED at
        # its cursor — resuming is free, the cursor is the state. FIFO
        # (byte-identical) when no policy is armed.
        queue = self.prefill_waiting if pol is None else \
            pol.admission_order(list(self.prefill_waiting))
        for job in queue:
            if room <= 0:
                break
            limit = self.prefill_chunk
            cap = getattr(job, "chunk_cap", 0)
            if cap:
                # degraded mode (overload layer): this job's chunks are
                # capped below the engine-wide chunk size, trading its
                # own prefill latency for co-resident decode TBT
                limit = min(limit, int(cap))
            n = min(limit, job.remaining(), room)
            if n > 0:
                items.append((job, n))
                room -= n
        return items

    def _note_prefill_progress(self, pitems, cursors_before) -> int:
        """Account chunks the engine landed this pass (it may decline a
        planned chunk — e.g. paged pool momentarily out of unreserved
        blocks — in which case the job just stays queued); evict jobs
        whose prompt is fully resident. Returns tokens landed."""
        landed = 0
        finished = []
        for (job, _n), c0 in zip(pitems, cursors_before):
            got = job.cursor - c0
            if got:
                landed += got
                job.chunks += 1
                job.t_progress = time.time()
                self.prefill_chunks.append((job.sid, self.iterations, got))
                if job.remaining() == 0:
                    finished.append(job)
        with self.cv:
            for job in finished:
                if job in self.prefill_waiting:
                    self.prefill_waiting.remove(job)
            if landed:
                # the queue is moving: refresh every waiter's progress
                # stamp so the starvation guard only fires when prefill
                # as a whole is stuck, not on tail jobs behind a long
                # but advancing FIFO
                now = time.time()
                for job in self.prefill_waiting:
                    job.t_progress = now
        for job in finished:
            self._evict_prefill(job)
        return landed

    def _expire_prefill(self):
        """Fail prefill jobs that made no progress for admit_timeout
        (paged pool can never serve their next chunk) — same starvation
        guard as decode admission."""
        if self.admit_timeout is None:
            return
        now = time.time()
        stuck = []
        with self.cv:
            for job in list(self.prefill_waiting):
                if now - job.t_progress > self.admit_timeout:
                    self.prefill_waiting.remove(job)
                    stuck.append(job)
        for job in stuck:
            self._evict_prefill(job, error=TimeoutError(
                f"prefill {job.sid} made no progress within "
                f"{self.admit_timeout}s (KV pool backpressure) at "
                f"{job.cursor}/{len(job.tokens)} tokens"))

    def _evict_prefill(self, job: PrefillJob,
                       error: Optional[Exception] = None):
        job.t_done = time.time()
        job.error = error
        if job.on_done is not None:
            # on_done runs engine/runtime bookkeeping on the loop
            # thread; a failure there must not kill the loop. It fires
            # BEFORE done is set, so job.wait() returning implies the
            # completion hooks (e.g. the speculative-drafter prefill
            # note) have already run.
            try:
                job.on_done(job)
            except Exception as e:  # noqa: BLE001
                self.callback_errors.append((job.sid, e))
        job.done.set()

    def _admit_locked(self):
        """Admit waiters into free slots; returns sequences that timed
        out waiting for engine admission (evicted by the caller OUTSIDE
        the condition variable — eviction hooks may take engine locks)."""
        admit_hook = getattr(self.engine, "try_admit", None)
        pol = getattr(self.engine, "slo", None)
        if pol is not None:
            return self._admit_slo_locked(admit_hook, pol)
        expired = []
        while self.waiting and len(self.active) < self.max_slots:
            seq = self.waiting[0]
            # engine-level admission control (paged KV backpressure: the
            # engine reserves the sequence's worst-case blocks, or defers
            # it). Head-of-line FIFO: if the head cannot be admitted, stop
            # — the loop retries every iteration / idle tick — unless it
            # has been deferred past admit_timeout, in which case it is
            # failed so it cannot starve the queue behind it.
            if admit_hook is not None and not admit_hook(seq):
                if self.admit_timeout is not None and \
                        time.time() - seq.t_submit > self.admit_timeout:
                    self.waiting.popleft()
                    expired.append(seq)
                    continue
                break
            self.waiting.popleft()
            seq.t_admit = time.time()
            self.active.append(seq)
            self.admissions.append((seq.sid, self.iterations))
            hook = getattr(self.engine, "note_slot_acquired", None)
            if hook is not None:
                hook(seq)
        return expired

    def _admit_slo_locked(self, admit_hook, pol):
        """SLO-mode admission: rank waiters (class, priority, e-graph
        depth, arrival — aging promotes starved batch work), consult the
        per-tenant slot fair share, and record whether an urgent waiter
        was deferred (the preemption trigger). Unlike FIFO mode a
        non-admissible waiter is SKIPPED, not head-of-line blocking —
        admission order is the rank order, so there is no FIFO contract
        to preserve behind it."""
        expired = []
        now = time.time()
        self._slo_deferred_urgent = False
        pol.note_live(pol.tag_of(s).tenant for s in self.waiting)
        demand = pol.slot_demand(self.waiting, self.active)
        for seq in pol.admission_order(list(self.waiting), now):
            deferred = False
            if len(self.active) >= self.max_slots:
                deferred = True
            elif not pol.may_take_slot(pol.tag_of(seq), demand):
                # over slot fair share while another tenant has unmet
                # demand — hold this one back, keep scanning (a
                # different tenant further down may still fit)
                deferred = True
            elif admit_hook is not None and not admit_hook(seq):
                deferred = True          # engine (KV) backpressure
            if deferred:
                if self.admit_timeout is not None and \
                        now - seq.t_submit > self.admit_timeout:
                    self.waiting.remove(seq)
                    expired.append(seq)
                elif pol.is_urgent(seq, now):
                    self._slo_deferred_urgent = True
                continue
            self.waiting.remove(seq)
            seq.t_admit = time.time()
            self.active.append(seq)
            self.admissions.append((seq.sid, self.iterations))
            pol.note_admit(seq)
            hook = getattr(self.engine, "note_slot_acquired", None)
            if hook is not None:
                hook(seq)
        return expired

    def _plan_preempt_locked(self):
        """SLO mode: when this pass deferred an urgent waiter while
        non-urgent sequences are resident, ask the policy's governor for
        a victim (cooldown + per-seq cap = hysteresis). Victims are
        pulled out of ``active`` here; the caller frees their KV and
        re-queues them OUTSIDE the condition variable (engine locks)."""
        pol = getattr(self.engine, "slo", None)
        if pol is None or not self._slo_deferred_urgent:
            return []
        can = getattr(self.engine, "can_preempt", None)
        cands = self.active if can is None else \
            [s for s in self.active if can(s)]
        victims = pol.plan_preemption(cands)
        for v in victims:
            self.active.remove(v)
        return victims

    def _evict(self, seq: DecodeSeq, error: Optional[Exception] = None):
        seq.t_done = time.time()
        if error is None:
            try:
                seq.result = seq.text_fn(seq)
            except Exception as e:  # noqa: BLE001
                error = e
        seq.error = error
        self.evictions.append((seq.sid, self.iterations, seq.steps))
        pol = getattr(self.engine, "slo", None)
        if pol is not None:
            pol.note_evict(seq, failed=error is not None)
        hook = getattr(self.engine, "note_slot_released", None)
        if hook is not None:
            hook(seq)
        seq.done.set()
        if seq.on_done is not None:
            # on_done runs runtime bookkeeping (store writes, graph
            # completion) on the loop thread; a failure there must not
            # kill the loop and strand the other resident sequences
            try:
                seq.on_done(seq)
            except Exception as e:  # noqa: BLE001
                self.callback_errors.append((seq.sid, e))

    def run(self):
        try:
            self._run_loop()
        except Exception as e:  # noqa: BLE001 — loop-thread death is fatal
            # satellite bugfix: a background decode-loop thread must not
            # swallow its own death — capture the first exception, mark
            # the owning engine suspect, and fail everything queued so
            # every submitting caller sees the error.
            self.fatal_error = e
            try:
                if getattr(self.engine, "health", "healthy") == "healthy":
                    self.engine.health = "suspect"
            except Exception:  # noqa: BLE001
                pass
        if self.fatal_error is not None:
            err: Exception = RuntimeError(
                f"decode loop died: {self.fatal_error!r}")
            err.__cause__ = self.fatal_error
        else:
            err = RuntimeError("decode loop stopped")
        # stopped or died: unblock anything still resident or queued
        with self.cv:
            self.running = False
            leftovers = list(self.active) + list(self.waiting)
            pleft = list(self.prefill_waiting)
            self.active.clear()
            self.waiting.clear()
            self.prefill_waiting.clear()
        for seq in leftovers:
            self._evict(seq, error=err)
        for job in pleft:
            self._evict_prefill(job, error=err)

    def _run_loop(self):
        while True:
            self.last_pass = time.time()
            with self.cv:
                if not self.running:
                    break
                expired = self._admit_locked()
                victims = self._plan_preempt_locked()
                if not self.active and not expired and not victims and \
                        not self.prefill_waiting:
                    self.cv.wait(timeout=self.idle_wait)
                    continue
                batch = list(self.active)
                self.max_resident = max(self.max_resident, len(batch))
                dcost = self._decode_cost(batch)
                pitems = self._take_prefill_locked(dcost)
                self._inflight_prefill = frozenset(
                    id(j) for j, _ in pitems)
                pwaiting = bool(self.prefill_waiting)
            for seq in expired:
                self._evict(seq, error=TimeoutError(
                    f"decode {seq.sid} not admitted within "
                    f"{self.admit_timeout}s (KV pool backpressure)"))
            if victims:
                # evict-to-recompute: free each victim's KV (engine call
                # — outside the cv), then re-queue it with its emitted
                # tokens intact; on re-admission the engine rebuilds KV
                # by re-prefilling prompt+emitted, so the continuation
                # is token-identical. The pass restarts so the freed
                # slots/blocks go to the urgent waiter immediately.
                pol = getattr(self.engine, "slo", None)
                with self.cv:
                    self._inflight_prefill = frozenset()
                    self.cv.notify_all()
                for v in victims:
                    try:
                        self.engine.preempt_decode(v)
                    except Exception as e:  # noqa: BLE001
                        self._evict(v, error=e)
                        continue
                    self.preemptions.append((v.sid, self.iterations,
                                             v.steps))
                    if pol is not None:
                        pol.note_preempted(v)
                    v.t_submit = time.time()   # fresh admission clock
                    with self.cv:
                        self.waiting.append(v)
                        self.cv.notify()
                continue
            if pwaiting and not pitems:
                # prefill queued but no chunk planned — either resident
                # decodes consume the whole budget every pass (room
                # permanently <= 0, e.g. speculative cost with a small
                # budget) or the queue drained between checks. The
                # starvation guard must fire HERE too, not only on idle
                # passes, so a budget-starved job fails loudly after
                # admit_timeout instead of hanging its query forever.
                self._expire_prefill()
            if not batch and not pitems:
                time.sleep(self.idle_wait)
                continue
            # an engine may emit SEVERAL tokens per sequence per pass
            # (speculative decoding: a verified draft chunk); progress is
            # the number of tokens appended, floor 1 for engines that
            # track progress elsewhere — plain engines append exactly one
            # token, preserving the legacy step-per-iteration behavior
            before = [len(seq.tokens) for seq in batch]
            pbefore = [job.cursor for job, _ in pitems]
            try:
                if pitems:
                    # mixed pass: all resident decode tokens first, then
                    # the budget's leftover as prefill chunks
                    self.engine.mixed_iteration(batch, pitems)
                else:
                    self.engine.decode_iteration(batch)
            except Exception as e:  # noqa: BLE001 — fail resident seqs
                with self.cv:
                    for seq in batch:
                        self.active.remove(seq)
                    for job, _ in pitems:
                        if job in self.prefill_waiting:
                            self.prefill_waiting.remove(job)
                    self._inflight_prefill = frozenset()
                    self.cv.notify_all()
                for seq in batch:
                    self._evict(seq, error=e)
                for job, _ in pitems:
                    self._evict_prefill(job, error=e)
                continue
            self.iterations += 1
            landed = self._note_prefill_progress(pitems, pbefore)
            if pitems:
                with self.cv:
                    self._inflight_prefill = frozenset()
                    self.cv.notify_all()
            if pitems:
                self.mixed_log.append(
                    (dcost, sum(n for _, n in pitems), landed))
                if not landed:
                    self._expire_prefill()
                    if not batch:     # nothing advanced at all this pass
                        time.sleep(self.idle_wait)
            if landed:
                # a prefill chunk landing changes pool block state
                # mid-pass: re-check engine admission for deferred
                # waiters NOW (try_admit is re-evaluated fresh — a
                # pre-chunk admission decision must never be reused)
                with self.cv:
                    late = self._admit_locked()
                for seq in late:
                    self._evict(seq, error=TimeoutError(
                        f"decode {seq.sid} not admitted within "
                        f"{self.admit_timeout}s (KV pool backpressure)"))
            finished, errored = [], []
            pol = getattr(self.engine, "slo", None)
            for seq, n_before in zip(batch, before):
                seq.steps += max(1, len(seq.tokens) - n_before)
                if pol is not None:
                    # TTFT on the first pass, TBT per pass after that
                    pol.note_tokens(seq)
                # a failing per-sequence emission (on_text runs stream
                # plumbing and the first-chunk early-release hook) fails
                # THAT sequence, never the shared loop
                try:
                    if seq.on_text is not None:
                        seq.on_text(seq.text_fn(seq))
                except Exception as e:  # noqa: BLE001
                    errored.append((seq, e))
                    continue
                if seq.steps >= seq.n:
                    finished.append(seq)
            if finished or errored:
                with self.cv:
                    for seq in finished:
                        self.active.remove(seq)
                    for seq, _ in errored:
                        self.active.remove(seq)
                for seq, e in errored:
                    self._evict(seq, error=e)
                for seq in finished:        # slot freed before next admit
                    self._evict(seq)


class DecodeLoopMixin:
    """Decode-loop lifecycle shared by the real and sim LLM engines.
    Host class must provide ``_lock``, ``max_batch`` and initialize
    ``_decode_loop = None``."""

    def start_decode_loop(self) -> ContinuousDecodeLoop:
        """Start (or return) this replica's persistent decode loop. An
        engine with ``chunked_prefill`` enabled hands the loop its
        prefill-chunk size and per-pass token budget, arming the loop's
        prefill queue (``submit_prefill``)."""
        with self._lock:
            if self._decode_loop is None or \
                    not self._decode_loop.is_alive():
                chunk = getattr(self, "prefill_chunk", 0) \
                    if getattr(self, "chunked_prefill", False) else 0
                self._decode_loop = ContinuousDecodeLoop(
                    self, max_slots=self.max_batch, prefill_chunk=chunk,
                    token_budget=getattr(self, "token_budget", None))
                self._decode_loop.start()
            return self._decode_loop

    def stop_decode_loop(self):
        with self._lock:
            loop = self._decode_loop
            self._decode_loop = None
        if loop is not None:
            loop.stop()

    def decode_slots_free(self) -> int:
        """Free decode slots (pool-router slot-aware routing input)."""
        loop = self._decode_loop
        if loop is None or not loop.is_alive():
            return self.max_batch
        return loop.slots_free()
