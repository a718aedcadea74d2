"""Fault injection and fault-tolerant serving (detection + recovery): a
copy of ``repro/serving/faults.py`` (it holds no tensors). The port's
copy keeps every thread it starts (the watchdog, the retries) so that the
runtime's shutdown can join them.

Three cooperating pieces:

``FaultInjector``
    Deterministic, seeded fault source. Engines that carry a non-None
    ``.faults`` attribute call ``fire(engine, point)`` at well-defined
    hook points ("decode", "prefill", "migrate", "alloc"); the injector
    counts calls per (replica, point) and triggers the configured fault
    at exactly the configured call index — crash (replica is dead from
    then on), hang/slow (sleep), migration failure, or allocator
    exhaustion. Seeded random schedules drive the chaos tests; parsed
    specs drive ``serve.py --fault-inject``. With no injector attached
    the hook is a single attribute read — the off path is byte-identical.

``FTConfig`` / ``RecoveryManager``
    Per-pooled-scheduler fault tolerance. The manager classifies
    failures (crash vs capacity vs bug), marks replica health in the
    ``EnginePool`` (suspect/dead with routing exclusion), reclaims a
    dead replica's paged blocks (``kv_cache.reclaim_replica`` — refcount
    audited), and runs a watchdog thread for hang detection (decode-loop
    heartbeat staleness) and per-request deadlines.

``TaskRecovery``
    One handle per loop-dispatched LLM task, bound by the executor
    submit functions. On a recoverable per-sequence failure it re-routes
    the sequence to a healthy replica with capped exponential backoff:
    the prompt is rebuilt from the query's e-graph (the orchestrator
    holds every prefill payload — app-level context module-level servers
    lack), already-emitted tokens are teacher-forced back into the KV
    cache, and greedy decode continues — the final text is
    token-identical to a no-fault run. When retries or the deadline are
    exhausted the task fails loudly with a structured ``RequestError``.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


# --------------------------------------------------------------------------
# errors


class FaultError(RuntimeError):
    """Base class for injected (or detected) replica faults."""


class ReplicaCrash(FaultError):
    """The replica process is gone: every call on it fails from now on."""


class MigrationFault(FaultError):
    """A paged-KV block transfer between replicas failed mid-flight."""


class RequestError(RuntimeError):
    """Structured request failure: carries enough context to answer
    *which* request failed, *where*, and *after how many attempts* —
    instead of a bare exception bubbling out of a worker thread."""

    def __init__(self, msg: str, *, qid: str = "", sid: str = "",
                 reason: str = "", attempts: int = 0, replica: str = ""):
        super().__init__(msg)
        self.qid = qid
        self.sid = sid
        self.reason = reason
        self.attempts = attempts
        self.replica = replica


class DeadlineExceeded(RequestError):
    """The per-request deadline expired before recovery could finish."""


#: error types worth retrying on a different replica (replica-local
#: failures). Anything else is treated as a bug and fails immediately.
RECOVERABLE = (FaultError, TimeoutError)


def is_recoverable(err) -> bool:
    if isinstance(err, RECOVERABLE):
        return True
    # allocator exhaustion / admission starvation is replica-local too:
    # another replica may have room. Checked by name to avoid importing
    # kv_cache here (OutOfBlocks lives there).
    if type(err).__name__ == "OutOfBlocks":
        return True
    return "decode loop" in str(err)  # loop stopped/died mid-flight


# --------------------------------------------------------------------------
# fault injection


_KINDS = ("crash", "hang", "slow", "migrate_fail", "alloc_fail", "burst")
_POINTS = ("decode", "prefill", "migrate", "alloc", "encode")


@dataclass
class FaultSpec:
    """One scheduled fault: trigger `kind` on replica `engine` at the
    `at`-th call of hook `point` (1-based). `duration` is the sleep for
    hang/slow/burst; `width` is the number of consecutive calls a
    ``burst`` (arrival-rate spike: every call in the window queues behind
    `duration` of extra backlog) stays hot."""
    kind: str
    engine: str
    point: str
    at: int = 1
    duration: float = 0.5
    width: int = 8

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {_KINDS})")
        if self.point not in _POINTS:
            raise ValueError(f"unknown fault point {self.point!r} "
                             f"(choose from {_POINTS})")
        if self.at < 1:
            raise ValueError("fault trigger index `at` is 1-based")
        if self.width < 1:
            raise ValueError("burst `width` must be >= 1")


class FaultInjector:
    """Deterministic fault source shared by every armed replica.

    Determinism: triggers depend only on per-(replica, point) call
    counts and the spec list — two runs with the same seed/specs and the
    same per-replica call interleaving fire identically. A ``crash`` is
    persistent: once fired, *every* subsequent hook call on that replica
    raises ``ReplicaCrash`` (the process is gone)."""

    def __init__(self, specs=(), seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self.rng = random.Random(seed)
        self._counts: Dict[Tuple[str, str], int] = {}
        self._dead = set()
        self._lock = threading.Lock()
        self.log: List[tuple] = []   # (kind, replica, point, call_index)

    # -- construction helpers ------------------------------------------

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultInjector":
        """Parse ``kind:engine:point:at[:duration[:width]]`` specs, comma
        separated — e.g. ``crash:core_llm.r1:decode:5,burst:lite_llm:prefill:1:0.05:6``."""
        specs = []
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) < 3:
                raise ValueError(
                    f"bad fault spec {part!r}: want "
                    f"kind:engine:point[:at[:duration[:width]]]")
            kind, engine, point = bits[0], bits[1], bits[2]
            at = int(bits[3]) if len(bits) > 3 else 1
            duration = float(bits[4]) if len(bits) > 4 else 0.5
            width = int(bits[5]) if len(bits) > 5 else 8
            specs.append(FaultSpec(kind, engine, point, at, duration, width))
        return cls(specs, seed=seed)

    @classmethod
    def random_schedule(cls, names, seed: int, n_faults: int = 1,
                        kinds=("crash",), points=("decode", "prefill"),
                        max_at: int = 6) -> "FaultInjector":
        """Seeded random fault schedule over `names` (chaos tests)."""
        rng = random.Random(seed)
        specs = [FaultSpec(rng.choice(list(kinds)), rng.choice(list(names)),
                           rng.choice(list(points)), rng.randint(1, max_at))
                 for _ in range(n_faults)]
        return cls(specs, seed=seed)

    def arm(self, engines, encoders: bool = False) -> list:
        """Attach this injector to every LLM replica reachable from an
        engines mapping (or an iterable of engines/pools). With
        ``encoders=True`` also arm embed/rerank replicas (the "encode"
        hook point — burst/slow faults on non-LLM engines). Returns the
        armed replica names."""
        from repro_torch.core.engine_pool import replicas_of
        vals = engines.values() if hasattr(engines, "values") else engines
        armed = []
        for eng in vals:
            for rep in replicas_of(eng):
                if hasattr(rep, "submit_decode") or (
                        encoders and (hasattr(rep, "op_embed")
                                      or hasattr(rep, "op_rerank"))):
                    rep.faults = self
                    armed.append(rep.name)
        return armed

    # -- runtime --------------------------------------------------------

    def dead_replicas(self) -> set:
        with self._lock:
            return set(self._dead)

    def fire(self, engine, point: str):
        """Engine hook. Raises / sleeps according to the schedule."""
        name = getattr(engine, "name", str(engine))
        with self._lock:
            if name in self._dead:
                raise ReplicaCrash(f"{name}: replica is dead (injected crash)")
            k = self._counts.get((name, point), 0) + 1
            self._counts[(name, point)] = k
            hits = [s for s in self.specs
                    if s.engine == name and s.point == point
                    and (k == s.at or (s.kind == "slow" and k >= s.at)
                         or (s.kind == "burst"
                             and s.at <= k < s.at + s.width))]
        for s in hits:
            self._trigger(s, engine, name, point, k)

    def _trigger(self, spec: FaultSpec, engine, name: str, point: str,
                 k: int):
        self.log.append((spec.kind, name, point, k))
        if spec.kind == "crash":
            with self._lock:
                self._dead.add(name)
            try:
                engine.health = "dead"
            except Exception:  # noqa: BLE001 — health attr is best-effort
                pass
            raise ReplicaCrash(
                f"{name}: injected crash at {point} call #{k}")
        if spec.kind in ("hang", "slow", "burst"):
            time.sleep(spec.duration)
            return
        if spec.kind == "migrate_fail":
            if point == "migrate":
                raise MigrationFault(
                    f"{name}: injected migration failure at transfer #{k}")
            return
        if spec.kind == "alloc_fail":
            if point == "alloc":
                from repro_torch.serving.kv_cache import OutOfBlocks
                raise OutOfBlocks(
                    f"{name}: injected allocator exhaustion at alloc #{k}")
            return


def fire(engine, point: str):
    """Module-level hook helper: no-op unless an injector is attached."""
    inj = getattr(engine, "faults", None)
    if inj is not None:
        inj.fire(engine, point)


# --------------------------------------------------------------------------
# fault-tolerance config


@dataclass
class FTConfig:
    """Fault-tolerance policy knobs (``Teola(..., fault_tolerance=...)``)."""
    max_retries: int = 2            # per-sequence recovery attempts
    request_deadline: Optional[float] = None  # s per dispatched LLM task
    backoff: float = 0.05           # base of exponential retry backoff (s)
    # heartbeat staleness thresholds: the loop stamps its heartbeat once
    # per pass, so these must exceed the worst-case SINGLE pass (a real
    # engine's first pass JIT-compiles and can take seconds) or a busy
    # replica is misread as hung
    suspect_after: float = 10.0     # loop heartbeat staleness -> suspect
    dead_after: float = 30.0        # loop heartbeat staleness -> dead
    watchdog_period: float = 0.2    # watchdog poll interval (s)


# --------------------------------------------------------------------------
# recovery manager (one per pooled scheduler)


class RecoveryManager:
    """Owns health marking, block reclamation, replica re-selection and
    the watchdog (hang + deadline detection) for one ``EnginePool``."""

    def __init__(self, sched, cfg: FTConfig):
        from repro_torch.core.runtime import ThreadGroup
        self.sched = sched
        self.pool = sched.pool
        self.cfg = cfg
        self._lock = threading.Lock()
        self._outstanding: Dict[int, "TaskRecovery"] = {}
        self._thread: Optional[threading.Thread] = None
        self.retries = ThreadGroup()      # TaskRecovery._retry threads
        self._running = True
        self.events: List[tuple] = []   # (kind, detail...) — tests/benches
        self.reclaim_reports: List[dict] = []

    # -- lifecycle ------------------------------------------------------

    def start(self):
        with self._lock:
            if self._thread is not None or not self._running:
                return
            self._thread = threading.Thread(
                target=self._watch, daemon=True,
                name=f"ft-watchdog:{getattr(self.pool, 'name', 'pool')}")
        self._thread.start()

    def stop(self):
        self._running = False

    def threads(self) -> List[threading.Thread]:
        """The watchdog and the retry threads, for shutdown to join."""
        with self._lock:
            watchdog = [self._thread] if self._thread else []
        return watchdog + self.retries.threads()

    # -- task registration ---------------------------------------------

    def handle(self, task, route: dict, kind: str) -> "TaskRecovery":
        h = TaskRecovery(self, task, route, kind)
        with self._lock:
            self._outstanding[id(h)] = h
        self.start()
        return h

    def finish(self, h: "TaskRecovery"):
        with self._lock:
            self._outstanding.pop(id(h), None)

    # -- health ---------------------------------------------------------

    def note_failure(self, idx: int, err) -> None:
        """Classify a failure observed on replica `idx` and mark health.
        Crash-like -> dead (+ reclaim); deadline/unknown -> suspect;
        capacity (OutOfBlocks) -> no mark, the replica is healthy-but-full."""
        if isinstance(err, ReplicaCrash) or "decode loop died" in str(err):
            self.mark_dead(idx, str(err))
        elif type(err).__name__ == "OutOfBlocks":
            pass
        elif isinstance(err, (MigrationFault, TimeoutError, Exception)):
            self.pool.mark_suspect(idx, str(err))

    def mark_dead(self, idx: int, reason: str = ""):
        first = self.pool.mark_dead(idx, reason)
        if not first:
            return
        rep = self.pool[idx]
        self.events.append(("replica_dead", rep.name, reason))
        try:
            from repro_torch.serving.kv_cache import reclaim_replica
            report = reclaim_replica(rep)
        except Exception as e:  # noqa: BLE001 — reclaim is best-effort
            report = {"engine": rep.name, "ok": False, "error": repr(e)}
        self.reclaim_reports.append(report)
        self.events.append(("reclaim", report))

    # -- routing --------------------------------------------------------

    def pick_replica(self, exclude=()) -> int:
        """Healthy replica for a recovery resubmit (slot/load aware)."""
        pool = self.pool
        base = getattr(pool, "route_decode_indices", None)
        indices = base() if base is not None else None
        cands = [i for i in (indices if indices is not None
                             else range(len(pool)))
                 if pool.health(i) != "dead" and i not in exclude]
        if not cands:
            cands = [i for i in (indices if indices is not None
                                 else range(len(pool)))
                     if pool.health(i) != "dead"]
        if not cands:
            raise ReplicaCrash(
                f"no healthy replica left in pool "
                f"({len(pool)} total, all dead)")
        return pool.least_loaded_decode(cands)

    def repin(self, task, idx: int):
        """Move the sequence's replica affinity to `idx`."""
        from repro_torch.core import primitives as P
        if task.prim.op not in P.LLM_OPS:
            return
        key = (task.ctx.qid, task.prim.config.get("sid", task.prim.pid))
        with self.sched._aff_lock:
            self.sched.affinity[key] = idx

    # -- prompt replay ---------------------------------------------------

    def rebuild_prompt(self, task, sid: str) -> str:
        """Reconstruct a sequence's full prompt from the query e-graph:
        the orchestrator resolved every prefill payload from the object
        store, so a dead replica's prompt is always recomputable. A
        prompt split by the causal-prefill pass (Pass 3) lives in TWO
        primitives — PartialPrefilling (early parts) + FullPrefilling
        (late parts) — so every matching piece is collected and joined
        in causal order; the whitespace tokenizer guarantees
        ``encode(a) + encode(b) == encode(a + " " + b)``, making the
        joined replay token-identical to the split original."""
        from repro_torch.core.executors import rebuild_full_prompt
        ctx = task.ctx
        full = rebuild_full_prompt(task.prim.engine, ctx, sid)
        if full is not None:
            return full
        raise ReplicaCrash(
            f"cannot rebuild prompt for {sid}: no matching prefill "
            f"primitive in query {ctx.qid}")

    # -- watchdog --------------------------------------------------------

    def _watch(self):
        cfg = self.cfg
        while self._running:
            time.sleep(cfg.watchdog_period)
            now = time.time()
            with self._lock:
                handles = list(self._outstanding.values())
            if not handles:
                continue
            # 1) heartbeat: a loop with pending work whose run thread has
            #    not completed a pass recently is hung (suspect -> dead)
            for idx in {h.route["idx"] for h in handles if not h.settled}:
                self._check_heartbeat(idx, now)
            # 2) per-request deadlines + dead-replica sweep (covers hangs,
            #    where no per-sequence callback will ever fire)
            for h in handles:
                if h.settled:
                    continue
                if h.deadline is not None and now >= h.deadline:
                    h.expire()
                elif self.pool.health(h.route["idx"]) == "dead":
                    h.recover_stranded()

    def _check_heartbeat(self, idx: int, now: float):
        pool = self.pool
        if pool.health(idx) == "dead":
            return
        loop = getattr(pool[idx], "_decode_loop", None)
        if loop is None:
            return
        busy = loop.occupancy() > 0 or bool(loop.prefill_waiting)
        if not busy:
            return
        stale = now - getattr(loop, "last_pass", now)
        if stale > self.cfg.dead_after:
            self.mark_dead(idx, f"heartbeat stale {stale:.2f}s")
        elif stale > self.cfg.suspect_after:
            pool.mark_suspect(idx, f"heartbeat stale {stale:.2f}s")


# --------------------------------------------------------------------------
# per-task recovery handle


class TaskRecovery:
    """Fault-tolerance handle for one loop-dispatched LLM task. The
    executor binds its entries and resubmit/fail callbacks; per-sequence
    failures route through :meth:`recover`."""

    def __init__(self, mgr: RecoveryManager, task, route: dict, kind: str):
        self.mgr = mgr
        self.cfg = mgr.cfg
        self.task = task
        self.route = route          # {"idx": int, "tokens": int} — mutable
        self.kind = kind            # "decode" | "prefill"
        # unified deadline: the watchdog enforces whichever is tighter —
        # the per-task FT budget or the query-level deadline stamped by
        # the overload layer (they share one clock; see serving/overload)
        dls = []
        if self.cfg.request_deadline:
            dls.append(time.time() + self.cfg.request_deadline)
        qdl = getattr(task.ctx, "deadline", None)
        if qdl is not None:
            dls.append(float(qdl))
        self.deadline = min(dls) if dls else None
        self._lock = threading.Lock()
        self.cancelled = False
        self.settled = False
        self.attempts: Dict[int, int] = {}
        self._state: Dict[int, str] = {}     # j -> live|recovering|done
        self._handles: Dict[int, object] = {}  # j -> DecodeSeq|PrefillJob
        self._on: Dict[int, int] = {}        # j -> replica idx submitted on
        self._sids: List[str] = []
        self._resubmit: Optional[Callable] = None
        self._fail: Optional[Callable] = None

    # -- executor binding ------------------------------------------------

    def bind(self, sids: List[str], resubmit: Callable, fail: Callable):
        self._sids = list(sids)
        self._resubmit = resubmit
        self._fail = fail
        for j in range(len(sids)):
            self._state.setdefault(j, "live")
            self._on.setdefault(j, self.route["idx"])

    def note_submitted(self, j: int, handle):
        with self._lock:
            self._handles[j] = handle
            if self._state.get(j) != "done":
                self._state[j] = "live"

    def note_done(self, j: int):
        with self._lock:
            self._state[j] = "done"

    def settle(self):
        with self._lock:
            self.settled = True
        self.mgr.finish(self)

    @property
    def qid(self) -> str:
        return self.task.ctx.qid

    def prompt_for(self, sid: str) -> str:
        return self.mgr.rebuild_prompt(self.task, sid)

    def wrap(self, err) -> RequestError:
        """Structured terminal error for this task."""
        if isinstance(err, RequestError):
            return err
        attempts = max(self.attempts.values(), default=0)
        rep = self.mgr.pool[self.route["idx"]]
        out = RequestError(
            f"request {self.qid}:{self.task.prim.pid} failed after "
            f"{attempts} recovery attempt(s) "
            f"(last replica {getattr(rep, 'name', '?')}): {err}",
            qid=self.qid, sid=self._sids[0] if self._sids else "",
            reason=type(err).__name__, attempts=attempts,
            replica=getattr(rep, "name", ""))
        out.__cause__ = err
        return out

    # -- recovery ---------------------------------------------------------

    def recover(self, j: int, handle) -> bool:
        """Executor hook: entry `j` failed with ``handle.error``. Marks
        replica health, and returns True when a retry was scheduled (the
        executor must then NOT count the entry as finished)."""
        with self._lock:
            cur = self._handles.get(j)
            on = self._on.get(j, self.route["idx"])
        if cur is not None and handle is not cur:
            # late eviction from a submission this entry already left
            # (the watchdog re-queued it elsewhere and the abandoned
            # loop drained afterwards) — the failure belongs to the old
            # replica, not whichever one now runs the entry; charging it
            # to route["idx"] would cascade-kill healthy replicas
            self.mgr.events.append(
                ("stale_failure", self.qid,
                 self._sids[j] if j < len(self._sids) else j,
                 repr(handle.error)))
            return True
        err = handle.error
        self.mgr.note_failure(on, err)
        return self._schedule(j, handle, err)

    def recover_submit(self, j: int, err) -> bool:
        """Scheduler-thread hook: submitting entry `j` raised before any
        loop handle existed (e.g. the routed replica died between
        routing and admission). Marks health and schedules a replay on a
        healthy replica when policy allows."""
        with self._lock:
            on = self._on.get(j, self.route["idx"])
        self.mgr.note_failure(on, err)
        return self._schedule(j, None, err)

    def recover_stranded(self):
        """Watchdog path: the routed replica is dead and hung — its
        per-sequence callbacks will never fire. Replay every still-live
        entry elsewhere."""
        for j, st in list(self._state.items()):
            if st == "live":
                self._schedule(j, self._handles.get(j),
                               ReplicaCrash("replica died while hung"))

    def _schedule(self, j: int, handle, err) -> bool:
        with self._lock:
            if self.cancelled or self._state.get(j) in ("done", "recovering"):
                return True    # already handled elsewhere; swallow
            if not is_recoverable(err):
                return False
            a = self.attempts.get(j, 0)
            if a >= self.cfg.max_retries:
                return False
            if self.deadline is not None and time.time() >= self.deadline:
                return False
            self.attempts[j] = a + 1
            self._state[j] = "recovering"
        delay = self.cfg.backoff * (2 ** a)
        self.mgr.retries.start(self._retry, (j, handle, delay),
                               name=f"ft-retry:{self.qid}:{j}")
        return True

    def _retry(self, j: int, handle, delay: float):
        try:
            time.sleep(delay)
            with self._lock:
                if self.cancelled:
                    return
            with self._lock:
                old = self._on.get(j, self.route["idx"])
            new = self.mgr.pick_replica(
                exclude={old} if len(self.mgr.pool) > 1 else ())
            if new != old:
                # move the load-ledger charge with the task
                self.mgr.pool.note_decode_finished(old, self.route["tokens"])
                self.mgr.pool.note_decode_submitted(new, self.route["tokens"])
                self.route["idx"] = new
            with self._lock:
                self._on[j] = new
            self.mgr.repin(self.task, new)
            self.mgr.events.append(
                ("retry", self.qid, self._sids[j] if j < len(self._sids)
                 else j, self.mgr.pool[new].name, self.attempts.get(j, 0)))
            with self._lock:
                if self.cancelled:
                    return
                self._state[j] = "live"
            self._resubmit(j, self.mgr.pool[new], handle)
        except Exception as e:  # noqa: BLE001 — recovery itself failed
            self._terminal(e)

    def expire(self):
        """Deadline passed: fail the whole task loudly, exactly once."""
        with self._lock:
            if self.settled or self.cancelled:
                return
            self.cancelled = True
        attempts = max(self.attempts.values(), default=0)
        err = DeadlineExceeded(
            f"request {self.qid}:{self.task.prim.pid} exceeded its "
            f"deadline after {attempts} "
            f"recovery attempt(s); sequences: {self._sids}",
            qid=self.qid, sid=self._sids[0] if self._sids else "",
            reason="deadline", attempts=attempts,
            replica=getattr(self.mgr.pool[self.route['idx']], "name", ""))
        self.mgr.events.append(("deadline", self.qid, self._sids))
        self._terminal(err, wrapped=True)

    def _terminal(self, err, wrapped: bool = False):
        fail = self._fail
        try:
            if fail is not None:
                fail(err if wrapped else self.wrap(err))
        finally:
            self.settle()
