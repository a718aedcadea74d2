"""Two-tier runtime (paper §5).

Upper tier — GraphScheduler: tracks each query's e-graph, dispatches
primitives whose in-degree reaches zero to the per-engine schedulers, and
manages the per-query object store.

Lower tier — one scheduler per engine *pool*:
  EngineScheduler        single-instance engines: one thread that fuses
                         primitive requests from concurrent queries into
                         engine batches.
  PooledEngineScheduler  EnginePool engines: the same batch-formation
                         policies over one shared queue, then a LOAD-AWARE
                         ROUTER dispatches each fused batch to the
                         least-loaded replica (outstanding tokens + KV
                         occupancy — see core/engine_pool.py), with
                         sequence->replica affinity for LLM ops since a
                         sequence's KV state lives on one replica.

Batching policies (both schedulers):
  'po'   per-invocation oriented — one query's bundle at a time (baseline)
  'to'   throughput oriented    — FIFO dynamic batching to max batch
  'topo' topology-aware batching — Algorithm 2: bucket by query, order by
         reverse-topological depth, earliest-arrival buckets first.

Streaming decode pipelining (partial-result emission): when the Runtime
is constructed with ``streaming=True``, an eligible Decoding primitive
publishes a TokenStream into the query store at dispatch time and the
engine emits decoded chunks into it as they are produced. On the FIRST
chunk the runtime early-releases the decode's graph children, so
downstream primitives (rerank, condition, aggregate, ...) are dispatched
— and can begin consuming via the stream — before sequence completion.
At completion the store key is overwritten with the plain final text, so
the final store is byte-identical to the non-streaming layout.

Control primitives (Condition/Aggregate) run inline on the graph
scheduler thread. Dependent pre-scheduling (§6, communication mitigation)
is modeled by resolving payloads lazily at execution time from the shared
object store, so a parent's output is visible to its pre-issued child
without an extra scheduler round-trip.

``Runtime.shutdown`` stops every thread the runtime drives — schedulers,
replica workers, hedges, recovery threads, decode loops and the threads
that dispatch early-released children — and joins each within one
bounded deadline, naming any still alive in the exception that follows.
A daemon thread left inside torch when the interpreter finalizes (a
scheduler still releasing a query's KV tensors, say) is killed by
CPython's ``pthread_exit`` while it waits for the GIL; the forced unwind
through torch's ``noexcept`` C++ frames calls ``std::terminate`` and the
process aborts.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch import tracing
from repro_torch.core import primitives as P
from repro_torch.core.engine_pool import (DisaggregatedEnginePool, EnginePool,
                                          estimate_tokens, replicas_of)
from repro_torch.core.primitives import Graph, Primitive
from repro_torch.core.streams import TokenStream

_qid = itertools.count()


class QueryContext:
    def __init__(self, graph: Graph, inputs: Dict[str, Any],
                 output_key: str = "answer", priority: int = 0,
                 slo: Optional[str] = None, tenant: str = "default"):
        self.qid = f"q{next(_qid)}"
        self.graph = graph
        self.store: Dict[str, Any] = dict(inputs)
        self.output_key = output_key
        self.priority = priority    # higher = served first (paper §7.2)
        # SLO class ("interactive" | "batch" | None) and tenant identity
        # for the serving/slo policy layer; None defers to priority
        self.slo = slo
        self.tenant = tenant
        self.done = threading.Event()
        self.t_submit = time.time()
        self.t_done: Optional[float] = None
        # absolute query deadline (stamped by the overload layer; None =
        # no deadline). The FT watchdog, SLO urgency test and the
        # degradation ladder all derive their clocks from this one value.
        self.deadline: Optional[float] = None
        self.node_spans: Dict[str, tuple] = {}     # pid -> (t0, t1)
        self.sids: set = set()
        self.lock = threading.Lock()
        self.error: Optional[Exception] = None
        # streaming: (parent_pid, child_pid) edges already released early
        self.early_edges: set = set()
        # the id of the query's span (tracing on at submit), parent of its
        # primitives' spans
        self.span_id: Optional[int] = None

    @property
    def latency(self):
        return (self.t_done or time.time()) - self.t_submit

    def result(self, timeout=120):
        self.done.wait(timeout)
        if self.error:
            raise self.error
        return self.store.get(self.output_key)


@dataclass
class NodeTask:
    prim: Primitive
    ctx: QueryContext
    t_arrival: float = field(default_factory=time.time)
    managed: bool = True     # False: baseline orchestrators drive progress
    stream: Optional[TokenStream] = None   # set for streaming decodes
    # tracing on: when its scheduler handed it to the engine (ns) and the
    # id of the ``batch`` span that held it
    t_run: Optional[int] = None
    batch: Optional[int] = None

    @property
    def depth(self):
        return self.prim.depth


def _run_batch(executor, engine, batch: List[NodeTask]):
    """One executor call of the lower tier. Tracing on, it is one
    ``batch`` span (the engine, the op, the rows, the queries), the parent
    of the engine's spans, and each task is stamped with the span's start
    and id: the edge between its ``prim.wait`` and its ``prim.run``."""
    if not tracing.enabled():
        executor(engine, batch)
        return
    with tracing.span("batch", engine=getattr(engine, "name", "?"),
                      op=batch[0].prim.op,
                      rows=sum(t.prim.num_requests for t in batch),
                      qids=sorted({t.ctx.qid for t in batch})) as sp:
        for t in batch:
            t.t_run, t.batch = sp.start, sp.id
        executor(engine, batch)


def _trace_prim(task: NodeTask, t0: float, t1: float):
    """A completed primitive's ``prim.wait`` (dispatch to the start of its
    batch) and ``prim.run`` (to completion): together its ``node_spans``
    interval."""
    if task.t_run is None:
        return
    prim, ctx = task.prim, task.ctx
    kw = dict(parent=ctx.span_id, qid=ctx.qid, pid=prim.pid, op=prim.op,
              engine=prim.engine)
    tracing.record("prim.wait", tracing.ns(t0), task.t_run, **kw)
    tracing.record("prim.run", task.t_run, tracing.ns(t1), batch=task.batch,
                   **kw)


def _fail_batch(batch: List[NodeTask], e: Exception):
    for t in batch:
        if t.stream is not None:
            t.stream.close()
        if t.ctx.error is None:
            # first error wins: a cascade failure (e.g. later submits
            # bouncing off an already-dead replica) must not overwrite
            # the structured root-cause error already recorded
            t.ctx.error = e
        t.ctx.done.set()


# ---------------------------------------------------------------------------
# Batch formation — shared by the single-instance and pooled schedulers.

def form_batch(pending: List[NodeTask], policy: str,
               max_bs: int) -> List[NodeTask]:
    if not pending:
        return []
    if policy == "po":
        # bundle = same (query, component) as the head task, FIFO
        head = min(pending, key=lambda t: t.t_arrival)
        bundle = [t for t in pending
                  if t.ctx is head.ctx
                  and t.prim.component == head.prim.component
                  and t.prim.op == head.prim.op]
        return bundle[:max_bs]
    if policy == "to":
        pending.sort(key=lambda t: t.t_arrival)
        op = pending[0].prim.op
        batch, slots = [], max_bs
        for t in pending:
            if t.prim.op != op:
                continue
            if t.prim.num_requests > slots and batch:
                break
            batch.append(t)
            slots -= t.prim.num_requests
            if slots <= 0:
                break
        return batch
    # 'topo' — Algorithm 2: bucket pending nodes by query; buckets
    # ordered by (priority desc, earliest arrival); round-robin over
    # buckets taking the HIGHEST-DEPTH node of each bucket per round
    # (Fig. 7 batches the most graph-advancing primitive of each
    # query together). Priority implements the paper's §7.2
    # app-priority discussion as primitive metadata.
    buckets: Dict[str, List[NodeTask]] = {}
    for t in pending:
        buckets.setdefault(t.ctx.qid, []).append(t)
    ordered = sorted(buckets.values(),
                     key=lambda b: (-max(t.ctx.priority for t in b),
                                    min(t.t_arrival for t in b)))
    for b in ordered:
        b.sort(key=lambda t: -t.prim.depth)
    batch, slots, op = [], max_bs, None
    while slots > 0:
        took = False
        for b in ordered:
            if slots <= 0:
                break
            for t in b:
                if op is not None and t.prim.op != op:
                    continue
                if t.prim.num_requests > slots and batch:
                    continue
                op = op or t.prim.op
                batch.append(t)
                b.remove(t)
                slots -= t.prim.num_requests
                took = True
                break
        if not took:
            break
    return batch


# ---------------------------------------------------------------------------

# ops dispatched into the persistent decode loop under continuous batching
CONTINUOUS_OPS = (P.DECODE, P.PARTIAL_DECODE)
# prefill ops additionally loop-dispatched when the engine has CHUNKED
# prefill enabled (prompts stream through mixed prefill/decode passes)
PREFILL_OPS = (P.PREFILL, P.PARTIAL_PREFILL, P.FULL_PREFILL)


def take_continuous(pending: List[NodeTask],
                    include_prefill: bool = False) -> List[NodeTask]:
    """Pull loop-destined tasks out of a pending list (caller holds the
    scheduler's condition lock): decodes always; prefills too when the
    engine runs chunked prefill inside the loop."""
    ops = CONTINUOUS_OPS + PREFILL_OPS if include_prefill \
        else CONTINUOUS_OPS
    cont = [t for t in pending if t.prim.op in ops]
    for t in cont:
        pending.remove(t)
    return cont


def chunked_prefill_enabled(engine) -> bool:
    """True when prefill primitives should bypass batch formation and be
    queued as chunked PrefillJobs in the engine's continuous loop."""
    return bool(getattr(engine, "chunked_prefill", False)) and \
        hasattr(engine, "submit_prefill")


SHUTDOWN_JOIN_S = 60.0     # one deadline for every join of a shutdown


class ThreadGroup:
    """Short-lived threads an owner starts (hedges, early-release
    dispatches, query chains), kept so that its shutdown can join them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []

    def start(self, target, args=(), name=None) -> threading.Thread:
        th = threading.Thread(target=target, args=args, daemon=True,
                              name=name)
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(th)
        th.start()
        return th

    def threads(self) -> List[threading.Thread]:
        with self._lock:
            return list(self._threads)


def join_threads(threads, deadline: float) -> List[str]:
    """Join each thread until ``deadline`` (``time.monotonic``); return
    the names of those still alive."""
    alive = []
    for th in threads:
        if th is threading.current_thread():
            continue
        th.join(max(0.0, deadline - time.monotonic()))
        if th.is_alive():
            alive.append(th.name)
    return alive


class EngineScheduler(threading.Thread):
    """Lower-tier scheduler for a SINGLE engine instance.

    With ``continuous=True`` (and an engine exposing ``submit_decode``)
    decode primitives bypass batch formation: they are submitted straight
    into the engine's persistent decode loop — the decode-slot dispatch
    mode — so the scheduler thread never blocks an engine for a whole
    decode batch and newly-arrived decodes join mid-flight. When the
    engine additionally runs CHUNKED prefill, prefill primitives are
    loop-dispatched the same way (``submit_prefill_task``): the prompt
    advances in budget-bounded chunks between decode iterations instead
    of head-of-line-blocking them."""

    def __init__(self, engine, executor, policy: str = "topo",
                 period: float = 0.002, continuous: bool = False):
        super().__init__(daemon=True,
                         name=f"sched:{getattr(engine, 'name', '?')}")
        self.engine = engine
        self.executor = executor
        self.policy = policy
        self.period = period
        self.continuous = continuous and hasattr(engine, "submit_decode")
        self.chunked = self.continuous and chunked_prefill_enabled(engine)
        self.pending: List[NodeTask] = []
        self.cv = threading.Condition()
        self.running = True
        self.on_complete = None        # set by Runtime
        self.batches = []              # (size_requests, op) log
        self.decode_submits = []       # (num_requests, op) loop submissions

    def submit(self, task: NodeTask):
        with self.cv:
            self.pending.append(task)
            self.cv.notify()

    def stop(self):
        self.running = False
        with self.cv:
            self.cv.notify()

    def threads(self) -> List[threading.Thread]:
        """The threads ``stop`` ends, for the runtime to join."""
        return [self]

    def _form_batch(self) -> List[NodeTask]:
        max_bs = getattr(self.engine, "max_batch", 8)
        return form_batch(self.pending, self.policy, max_bs)

    def _submit_continuous(self, tasks: List[NodeTask]):
        from repro_torch.core.executors import (submit_decode_task,
                                                submit_prefill_task)
        for t in tasks:
            self.decode_submits.append((t.prim.num_requests, t.prim.op))
            if tracing.enabled():
                t.t_run = time.time_ns()
            submit = submit_prefill_task if t.prim.op in PREFILL_OPS \
                else submit_decode_task
            try:
                submit(self.engine, t, self.on_complete)
            except Exception as e:  # noqa: BLE001
                _fail_batch([t], e)

    def run(self):
        while self.running:
            with self.cv:
                if not self.pending:
                    self.cv.wait(timeout=0.1)
                    continue
                cont = take_continuous(self.pending, self.chunked) \
                    if self.continuous else []
                batch = self._form_batch()
                for t in batch:
                    self.pending.remove(t)
            self._submit_continuous(cont)
            if not batch:
                if not cont:
                    time.sleep(self.period)
                continue
            self.batches.append((sum(t.prim.num_requests for t in batch),
                                 batch[0].prim.op))
            try:
                _run_batch(self.executor, self.engine, batch)
            except Exception as e:  # noqa: BLE001
                _fail_batch(batch, e)
                continue
            for t in batch:
                self.on_complete(t)


# ---------------------------------------------------------------------------

class _ReplicaWorker(threading.Thread):
    """Executes routed batches on one pool replica; maintains the pool's
    in-flight token ledger around each execution."""

    def __init__(self, sched: "PooledEngineScheduler", idx: int):
        name = getattr(sched.pool[idx], "name", idx)
        super().__init__(daemon=True, name=f"worker:{name}")
        self.sched = sched
        self.idx = idx
        self.engine = sched.pool[idx]
        self.q: "queue.Queue" = queue.Queue()

    def run(self):
        pool = self.sched.pool
        while True:
            item = self.q.get()
            if item is None:
                return
            batch, tokens = item
            pool.note_started(self.idx, tokens)
            try:
                fire = self.sched._execute_routed(self, batch, tokens)
            except Exception as e:  # noqa: BLE001
                if not self.sched._retry_routed(self, batch, tokens, e):
                    _fail_batch(batch,
                                self.sched._wrap_batch_error(self, batch,
                                                             e))
                continue
            finally:
                pool.note_finished(self.idx, tokens)
            if not fire:
                continue   # hedge machinery already fired completions
            for t in batch:
                try:
                    self.sched.on_complete(t)
                except Exception as e:  # noqa: BLE001
                    # a completion-hook failure must fail THAT task, not
                    # silently kill this worker thread
                    _fail_batch([t], e)


def _seq_key(task: NodeTask) -> Optional[tuple]:
    """Replica-affinity key: LLM ops act on a named sequence whose KV
    state lives on exactly one replica."""
    if task.prim.op not in P.LLM_OPS:
        return None
    return (task.ctx.qid, task.prim.config.get("sid", task.prim.pid))


class PooledEngineScheduler(threading.Thread):
    """Lower-tier scheduler for an EnginePool: forms fused batches from
    one shared queue under the same policies, then routes each batch to a
    replica. Routing is load-aware (least outstanding tokens, including
    KV occupancy) with sequence affinity: once a sequence's prefill lands
    on a replica, every later op of that sequence follows it. A fused
    batch that spans sequences pinned to different replicas is partitioned
    into per-replica sub-batches.

    With ``continuous=True``, decode primitives skip the replica worker
    queues: each is routed (affinity first, then SLOT-AWARE least-load —
    a replica with a free decode slot beats a loaded one) and submitted
    into that replica's persistent decode loop. With chunked prefill
    enabled on the replicas, prefill primitives are loop-dispatched the
    same way — affinity binds a partially prefilled sequence to the
    replica holding its KV; fresh prompts go to the least-loaded replica
    (block-exhausted paged replicas demoted), whose loop then lands the
    chunks between its decode iterations."""

    def __init__(self, pool: EnginePool, executor, policy: str = "topo",
                 period: float = 0.002, continuous: bool = False,
                 fault_tolerance=None, overload=None):
        super().__init__(daemon=True,
                         name=f"sched:{getattr(pool, 'name', '?')}")
        self.pool = pool
        self.engine = pool[0]          # profile source (max_batch, kind)
        self.executor = executor
        self.policy = policy
        self.period = period
        # overload layer (OverloadManager): hedged dispatch for
        # idempotent non-LLM routed batches. None (the default) keeps
        # _execute_routed a plain executor call — byte-identical.
        self.overload = overload
        self.continuous = continuous and hasattr(pool[0], "submit_decode")
        self.chunked = self.continuous and chunked_prefill_enabled(pool[0])
        # fault tolerance (FTConfig): a RecoveryManager owns replica
        # health marking, block reclamation, watchdog hang/deadline
        # detection and per-task recovery handles. None (the default)
        # leaves every dispatch path byte-identical.
        self.ftmgr = None
        if fault_tolerance is not None and \
                hasattr(pool[0], "submit_decode"):
            from repro_torch.serving.faults import RecoveryManager
            self.ftmgr = RecoveryManager(self, fault_tolerance)
            self.ftmgr.start()
        # disaggregated prefill/decode dispatch: prefill ops see only the
        # prefill-specialist replicas, decodes only the decode side (with
        # a KV migration when the sequence was prefilled elsewhere). For
        # plain pools both index sets stay None — every routing call
        # below is byte-identical to the pre-role scheduler.
        self.disagg = isinstance(pool, DisaggregatedEnginePool) and \
            self.continuous
        self._prefill_idx = pool.prefill_indices if self.disagg else None
        self._decode_idx = pool.decode_indices if self.disagg else None
        # graceful degradation: with replicas dead, the pool's route_*
        # views exclude them (demoting to colocated mode when one whole
        # role is gone). All-healthy they equal the static partitions.
        # prefix-aware prefill routing: only when some replica carries a
        # radix prefix cache — flag off keeps routing byte-identical
        self.prefix_aware = any(
            getattr(r, "prefix_cache_mode", "none") == "radix"
            for r in pool)
        self.pending: List[NodeTask] = []
        self.cv = threading.Condition()
        self.running = True
        self.on_complete = None
        self.batches = []              # (size_requests, op) log
        self.decode_submits = []       # (num_requests, op) loop submissions
        self.routes = []               # (replica_idx, op, n_requests, tokens)
        self.affinity: Dict[tuple, int] = {}
        self._aff_lock = threading.Lock()
        self.hedges = ThreadGroup()    # backup dispatches still running
        self.workers = [_ReplicaWorker(self, i) for i in range(len(pool))]
        for w in self.workers:
            w.start()

    def submit(self, task: NodeTask):
        with self.cv:
            self.pending.append(task)
            self.cv.notify()

    def stop(self):
        self.running = False
        if self.ftmgr is not None:
            self.ftmgr.stop()
        with self.cv:
            self.cv.notify()
        for w in self.workers:
            w.q.put(None)

    def threads(self) -> List[threading.Thread]:
        """The threads ``stop`` ends, for the runtime to join."""
        out = [self] + self.workers + self.hedges.threads()
        if self.ftmgr is not None:
            out += self.ftmgr.threads()
        return out

    def _pf_idx(self):
        return self.pool.route_prefill_indices() if self.disagg else None

    def _dc_idx(self):
        return self.pool.route_decode_indices() if self.disagg else None

    def _slo_tenant(self, t: NodeTask):
        """Tenant identity for decode routing — only when the replicas
        carry an armed SLO policy (None keeps routing byte-identical)."""
        if getattr(self.pool[0], "slo", None) is None:
            return None
        return getattr(t.ctx, "tenant", "default")

    def forget(self, qid: str):
        """Drop a finished query's sequence-affinity entries."""
        with self._aff_lock:
            for k in [k for k in self.affinity if k[0] == qid]:
                del self.affinity[k]

    def _form_batch(self) -> List[NodeTask]:
        max_bs = getattr(self.engine, "max_batch", 8)
        return form_batch(self.pending, self.policy, max_bs)

    def _prefix_route(self, t: NodeTask):
        """Radix prefix-affinity probe for an UNPINNED prefill: the
        replica whose tree holds the longest cached prefix of the
        task's prompt (None -> no replica beats a cold prefill; caller
        falls back to least-loaded). Best-effort: payload construction
        needs upstream store values, and any surprise there must route,
        not raise."""
        if not self.prefix_aware or t.prim.op not in PREFILL_OPS:
            return None
        from repro_torch.core.executors import _prefill_payload
        from repro_torch.core.streams import TokenStream

        def has_stream(v):
            if isinstance(v, TokenStream):
                return True
            if isinstance(v, (list, tuple)):
                return any(has_stream(x) for x in v)
            if isinstance(v, dict):
                return any(has_stream(x) for x in v.values())
            return False

        store = t.ctx.store
        keys = [k for _, k in t.prim.config.get("parts", [])
                if k is not None]
        if "items_key" in t.prim.config:
            keys.append(t.prim.config["items_key"])
        if any(has_stream(store.get(k)) for k in keys):
            # a streaming part would BLOCK payload construction until
            # the upstream decode finishes — never stall the router
            return None
        try:
            payload = _prefill_payload(t.prim, t.ctx)
            if not payload:
                return None
            return self.pool.best_prefix_replica(payload[0]["text"],
                                                 self._pf_idx())
        except Exception:  # noqa: BLE001
            return None

    def _submit_continuous(self, tasks: List[NodeTask]):
        """Route each loop-destined task to a replica (KV affinity
        binds; otherwise decodes go slot-aware least-load, prefill
        chunks block-aware least-load) and admit it into that replica's
        loop."""
        from repro_torch.core.executors import (submit_decode_task,
                                                submit_prefill_task)
        for t in tasks:
            is_prefill = t.prim.op in PREFILL_OPS
            key = _seq_key(t)
            with self._aff_lock:
                idx = self.affinity.get(key) if key is not None else None
                if idx is not None and self.ftmgr is not None and \
                        self.pool.health(idx) == "dead":
                    # pinned replica died since the last op: drop the pin
                    # and re-route; the executor replays the sequence via
                    # recover_decode on the fresh replica
                    del self.affinity[key]
                    idx = None
                if idx is None:
                    if is_prefill:
                        # prefix affinity first: the replica with the
                        # longest radix-cached prefix skips that much
                        # prefill compute
                        idx = self._prefix_route(t)
                        if idx is None:
                            idx = self.pool.least_loaded(self._pf_idx())
                    else:
                        idx = self.pool.least_loaded_decode(
                            self._dc_idx(), tenant=self._slo_tenant(t))
                    if key is not None:
                        self.affinity[key] = idx
            if self.disagg and not is_prefill and \
                    idx < self.pool.n_prefill:
                # two-stage dispatch: the sequence finished prefill on a
                # prefill specialist — migrate its KV to a decode
                # specialist before loop admission
                try:
                    idx = self._handoff(t, idx)
                except Exception as e:  # noqa: BLE001
                    _fail_batch([t], e)
                    continue
            tokens = estimate_tokens(t.prim)
            if tracing.enabled():
                t.t_run = time.time_ns()
            self.pool.note_decode_submitted(idx, tokens)
            self.routes.append((idx, t.prim.op, t.prim.num_requests,
                                tokens))
            self.decode_submits.append((t.prim.num_requests, t.prim.op))
            # route is MUTABLE: recovery re-routes a task's sequences to
            # another replica mid-flight and updates route["idx"], so the
            # ledger release lands on the replica that actually ran it
            route = {"idx": idx, "tokens": tokens}

            def _done(task, route=route):
                self.pool.note_decode_finished(route["idx"],
                                               route["tokens"])
                self.on_complete(task)

            def _fail(task, route=route):
                # release the ledger even when the task errors (done is
                # not called on the error path)
                self.pool.note_decode_finished(route["idx"],
                                               route["tokens"])

            ft = None
            if self.ftmgr is not None:
                ft = self.ftmgr.handle(
                    t, route, "prefill" if is_prefill else "decode")
            submit = submit_prefill_task if is_prefill \
                else submit_decode_task
            try:
                submit(self.pool[idx], t, _done, on_fail=_fail, ft=ft)
            except Exception as e:  # noqa: BLE001
                if ft is not None:
                    e = ft.wrap(e)   # structured error, not a bare crash
                    ft.settle()
                self.pool.note_decode_finished(route["idx"],
                                               route["tokens"])
                _fail_batch([t], e)

    def _handoff(self, t: NodeTask, src_idx: int) -> int:
        """Second dispatch stage (disaggregated pools): the sequence(s)
        of a decode task were prefilled on prefill replica ``src_idx`` —
        pick the slot/block-aware best decode replica, migrate each
        sequence's KV there (``export_seq`` -> ``import_seq``: blocks
        staged out of the source pool into freshly reserved destination
        blocks, source released atomically) and re-pin affinity so every
        later op of the sequence follows the decode replica. Runs on the
        scheduler thread: the staging copy overlaps the destination
        loop's iteration cadence — resident decodes never stop ticking
        while a handoff is in flight."""
        from repro_torch.core.executors import decode_entries
        dst_idx = self.pool.least_loaded_decode(
            self._dc_idx(), tenant=self._slo_tenant(t))
        if dst_idx == src_idx:
            # degraded pool: the whole decode side is dead and routing
            # demoted to colocated mode — the KV already lives here
            return src_idx
        src, dst = self.pool[src_idx], self.pool[dst_idx]
        try:
            for sid, _ in decode_entries(t.prim, t.ctx):
                if sid in getattr(src, "states", {}):
                    dst.import_seq(src.export_seq(sid))
                    self.pool.note_migration(sid, src_idx, dst_idx)
        except Exception as e:  # noqa: BLE001
            if self.ftmgr is None:
                raise
            # transfer fault: mark the destination and decode colocated
            # on the prefill replica instead. Sequences whose state was
            # already moved off src are replayed there by the executor's
            # recover_decode path (their KV is simply missing on src).
            self.ftmgr.note_failure(dst_idx, e)
            self.ftmgr.events.append(
                ("handoff_fallback", t.ctx.qid, src_idx, dst_idx,
                 repr(e)))
            key = _seq_key(t)
            if key is not None:
                with self._aff_lock:
                    self.affinity[key] = src_idx
            return src_idx
        key = _seq_key(t)
        if key is not None:
            with self._aff_lock:
                self.affinity[key] = dst_idx
        return dst_idx

    # -- the replica router -------------------------------------------------
    def _route(self, batch: List[NodeTask]):
        """Partition a fused batch by sequence affinity; everything
        unpinned goes — as one fused sub-batch — to the least-loaded
        replica and pins its sequences there."""
        groups: Dict[int, List[NodeTask]] = {}
        unpinned: List[NodeTask] = []
        with self._aff_lock:
            for t in batch:
                key = _seq_key(t)
                idx = self.affinity.get(key) if key is not None else None
                if idx is None:
                    unpinned.append(t)
                else:
                    groups.setdefault(idx, []).append(t)
            if unpinned:
                # disaggregated pools: routed batches are prefill work
                # (decodes go through _submit_continuous) — keep them on
                # the prefill specialists
                idx = self.pool.least_loaded(self._pf_idx())
                for t in unpinned:
                    # radix prefix affinity can split a task off the
                    # fused sub-batch — reusing a long cached prefix
                    # beats batching a cold prefill (prefix_aware off:
                    # pidx is always None, one fused sub-batch as before)
                    pidx = self._prefix_route(t)
                    tidx = pidx if pidx is not None else idx
                    groups.setdefault(tidx, []).append(t)
                    key = _seq_key(t)
                    if key is not None:
                        self.affinity[key] = tidx
        for idx, tasks in groups.items():
            tokens = sum(estimate_tokens(t.prim) for t in tasks)
            self.pool.note_queued(idx, tokens)
            self.routes.append((idx, tasks[0].prim.op,
                                sum(t.prim.num_requests for t in tasks),
                                tokens))
            self.workers[idx].q.put((tasks, tokens))

    # -- hedged execution of routed batches ---------------------------------
    def _hedge_delay(self, batch: List[NodeTask]):
        """Backup-issue delay for a routed batch, or None not to hedge:
        requires an armed overload manager, an idempotent op, >1 healthy
        replica and an armed trigger (fixed or percentile)."""
        ov = self.overload
        if ov is None or len(self.pool) < 2:
            return None
        from repro_torch.serving.overload import HEDGEABLE_OPS
        if batch[0].prim.op not in HEDGEABLE_OPS:
            return None
        return ov.hedge.trigger_delay(batch[0].prim.op)

    def _execute_routed(self, worker, batch: List[NodeTask],
                        tokens: int) -> bool:
        """Run one routed batch on its replica, optionally hedged.
        Returns True when the CALLER should fire the completion hooks
        (plain path / primary won), False when the hedge machinery
        already fired them (backup won)."""
        op = batch[0].prim.op
        ov = self.overload
        delay = self._hedge_delay(batch)
        if delay is None:
            t0 = time.time()
            _run_batch(self.executor, worker.engine, batch)
            if ov is not None:
                from repro_torch.serving.overload import HEDGEABLE_OPS
                if op in HEDGEABLE_OPS:
                    ov.hedge.note_latency(op, time.time() - t0)
            return True
        # hedged: first-result-wins. Both executions write identical
        # values into the query store (the ops are deterministic and
        # idempotent), so the "winner" decides only WHO fires the
        # completion hooks — exactly once, guarded by `st`.
        st = {"winner": None, "launched": False}
        lock = threading.Lock()
        primary_done = threading.Event()

        def _fire():
            for t in batch:
                try:
                    self.on_complete(t)
                except Exception as e:  # noqa: BLE001
                    _fail_batch([t], e)

        def _backup():
            if primary_done.wait(delay):
                return                      # primary beat the trigger
            cands = [i for i in self.pool.healthy_indices()
                     if i != worker.idx]
            if not cands:
                return
            bidx = self.pool.least_loaded(cands)
            with lock:
                if st["winner"] is not None:
                    return
                st["launched"] = True
            ov.hedge.note_issued()
            self.pool.note_queued(bidx, tokens)
            self.pool.note_started(bidx, tokens)
            try:
                self.executor(self.pool[bidx], batch)
            except Exception:  # noqa: BLE001
                # a hedge failure is NEVER double-counted: no health
                # mark, no retry charge — the primary path stands alone
                ov.hedge.note_backup_failure()
                return
            finally:
                self.pool.note_finished(bidx, tokens)
            with lock:
                if st["winner"] is not None:
                    ov.hedge.note_loss()    # primary already won
                    return
                st["winner"] = "backup"
            ov.hedge.note_win()
            _fire()

        th = self.hedges.start(_backup,
                               name=f"hedge:{batch[0].ctx.qid}:{op}")
        t0 = time.time()
        try:
            _run_batch(self.executor, worker.engine, batch)
        except Exception:
            primary_done.set()
            with lock:
                launched = st["launched"]
            if launched:
                # the backup may still rescue the batch — wait for its
                # verdict before failing the tasks
                th.join(timeout=120)
                with lock:
                    if st["winner"] == "backup":
                        ov.hedge.note_rescue()
                        return False   # hedge completed the batch
            raise
        primary_done.set()
        ov.hedge.note_latency(op, time.time() - t0)
        with lock:
            if st["winner"] is not None:
                ov.hedge.note_loss()       # backup beat us; discard ours
                return False
            st["winner"] = "primary"
        return True

    def _retry_routed(self, worker, batch: List[NodeTask], tokens: int,
                      err: Exception) -> bool:
        """A routed (run-to-completion) batch blew up on a replica.
        With fault tolerance on and the error recoverable, mark the
        replica, unpin the batch's sequences from it, and re-route the
        whole batch — capped by cfg.max_retries attempts per task."""
        mgr = self.ftmgr
        if mgr is None:
            return False
        from repro_torch.serving.faults import is_recoverable
        mgr.note_failure(worker.idx, err)
        if not is_recoverable(err):
            return False
        for t in batch:
            a = getattr(t, "ft_attempts", 0)
            if a >= mgr.cfg.max_retries:
                return False
            t.ft_attempts = a + 1
        time.sleep(mgr.cfg.backoff)
        with self._aff_lock:
            for k in [k for k, v in self.affinity.items()
                      if v == worker.idx]:
                del self.affinity[k]
        mgr.events.append(("retry_batch", worker.idx, len(batch),
                           repr(err)))
        self._route(batch)
        return True

    def _wrap_batch_error(self, worker, batch: List[NodeTask],
                          err: Exception) -> Exception:
        """Structured terminal error for a batch-path failure when fault
        tolerance is on (parity with ``TaskRecovery.wrap`` — a request
        must never fail with a bare replica exception)."""
        from repro_torch.serving.faults import RequestError
        if self.ftmgr is None or isinstance(err, RequestError):
            return err
        rep = self.pool[worker.idx]
        t = batch[0]
        out = RequestError(
            f"request {t.ctx.qid}:{t.prim.pid} failed after "
            f"{getattr(t, 'ft_attempts', 0)} recovery attempt(s) "
            f"(replica {getattr(rep, 'name', '?')}): {err}",
            qid=t.ctx.qid, reason=type(err).__name__,
            attempts=getattr(t, "ft_attempts", 0),
            replica=getattr(rep, "name", ""))
        out.__cause__ = err
        return out

    def run(self):
        while self.running:
            with self.cv:
                if not self.pending:
                    self.cv.wait(timeout=0.1)
                    continue
                cont = take_continuous(self.pending, self.chunked) \
                    if self.continuous else []
                batch = self._form_batch()
                for t in batch:
                    self.pending.remove(t)
            self._submit_continuous(cont)
            if not batch:
                if not cont:
                    time.sleep(self.period)
                continue
            self.batches.append((sum(t.prim.num_requests for t in batch),
                                 batch[0].prim.op))
            self._route(batch)


# ---------------------------------------------------------------------------

# ops whose output can be streamed chunk-wise to downstream consumers
STREAMABLE_OPS = {P.DECODE, P.PARTIAL_DECODE}


def stream_eligible(prim: Primitive) -> bool:
    """A decode can stream when it emits ONE plain-text value (per-item
    sequences and multi-item splits post-process the final text)."""
    return (prim.op in STREAMABLE_OPS
            and not prim.config.get("per_item_seq")
            and prim.config.get("num_items", 1) <= 1
            and not prim.config.get("also_aggregate")
            and prim.config.get("stream", True))


class Runtime:
    """Graph scheduler + one lower-tier scheduler per engine pool.
    An engines-dict value may be a bare engine, an EnginePool, or a
    legacy list of replicas (wrapped into an EnginePool when len > 1).
    ``streaming=True`` enables decode->downstream chunk pipelining.
    ``continuous_batching=True`` enables the decode-slot dispatch mode:
    decode primitives are admitted into each LLM replica's persistent
    decode loop (iteration-level continuous batching) instead of being
    executed as blocking run-to-completion batches."""

    def __init__(self, engines: Dict[str, Any], policy: str = "topo",
                 streaming: bool = False,
                 continuous_batching: bool = False,
                 fault_tolerance=None, overload=None):
        from repro_torch.core.executors import execute_batch
        self.engines = engines
        self.policy = policy
        self.streaming = streaming
        self.continuous_batching = continuous_batching
        self.fault_tolerance = fault_tolerance
        # overload layer (serving/overload.OverloadManager): front-door
        # admission control + deadline stamping here, hedged dispatch in
        # the pooled schedulers, degradation hooks in the executors.
        # None (the default) keeps every path byte-identical.
        self.overload = overload
        self.scheds: Dict[str, Any] = {}
        for name, eng in engines.items():
            if isinstance(eng, list):
                eng = EnginePool(eng, name=name) if len(eng) > 1 else eng[0]
            if isinstance(eng, EnginePool):
                s = PooledEngineScheduler(eng, execute_batch, policy,
                                          continuous=continuous_batching,
                                          fault_tolerance=fault_tolerance,
                                          overload=overload)
                if overload is not None and \
                        hasattr(eng[0], "submit_decode"):
                    # LLM pools feed the admission controller's queue-
                    # delay estimate (non-LLM pools are never the
                    # capacity bottleneck the front door guards)
                    overload.admission.register_pool(eng)
            else:
                s = EngineScheduler(eng, execute_batch, policy,
                                    continuous=continuous_batching)
            s.on_complete = self._on_complete
            s.start()
            self.scheds[name] = s
        self.queries: List[QueryContext] = []
        self._lock = threading.Lock()
        # threads started on behalf of queries (early-release dispatches
        # here, module-chain runs of the baselines), joined at shutdown
        self.aux = ThreadGroup()

    def submit(self, graph: Graph, inputs: Dict[str, Any],
               output_key: str = "answer", priority: int = 0,
               slo: Optional[str] = None,
               tenant: str = "default") -> QueryContext:
        ctx = QueryContext(graph, inputs, output_key, priority=priority,
                           slo=slo, tenant=tenant)
        ctx.span_id = tracing.new_id()
        with self._lock:
            self.queries.append(ctx)
        if self.overload is not None:
            from repro_torch.serving.overload import query_class
            cls = query_class(slo, priority)
            self.overload.stamp(ctx, graph, cls)
            err = self.overload.admit(ctx, cls)
            if err is not None:
                # load shed at the front door: the query never consumes
                # engine capacity — structured error, done immediately
                ctx.indegree = {}
                ctx.error = err
                ctx.t_done = time.time()
                ctx.done.set()
                return ctx
        ctx.indegree = {pid: len(n.parents)
                        for pid, n in graph.nodes.items()}
        for n in graph.roots():
            self._dispatch(n, ctx)
        if not graph.nodes:
            self._finish(ctx)
        return ctx

    def _dispatch(self, prim: Primitive, ctx: QueryContext):
        ctx.node_spans.setdefault(prim.pid, (time.time(), None))
        if prim.engine == "control":
            self._run_control(prim, ctx)
            self._complete_node(prim, ctx)
            return
        task = NodeTask(prim, ctx)
        if self.streaming and stream_eligible(prim):
            task.stream = self._open_stream(prim, ctx)
        self.scheds[prim.engine].submit(task)

    def _open_stream(self, prim: Primitive, ctx: QueryContext):
        """Partial-result emission path: publish a TokenStream under the
        decode's output key and arm the first-chunk early-release hook."""
        from repro_torch.core.executors import _out_key
        key = prim.config.get("out_key", _out_key(prim))
        stream = TokenStream(key)
        stream.on_first = lambda: self._stream_ready(prim, ctx)
        ctx.store[key] = stream
        return stream

    def _stream_ready(self, prim: Primitive, ctx: QueryContext):
        """First decoded chunk is out: release the decode's children
        early. Runs on the engine executor thread MID-DECODE, so children
        are dispatched from fresh threads — a control primitive that
        blocks on the stream must not stall the decode loop."""
        ready = []
        with ctx.lock:
            for cpid in prim.children:
                edge = (prim.pid, cpid)
                if edge in ctx.early_edges:
                    continue
                ctx.early_edges.add(edge)
                ctx.indegree[cpid] -= 1
                if ctx.indegree[cpid] == 0:
                    ready.append(ctx.graph.nodes[cpid])
        for n in ready:
            self.aux.start(self._dispatch, (n, ctx),
                           name=f"dispatch:{ctx.qid}:{n.pid}")

    def _run_control(self, prim: Primitive, ctx: QueryContext):
        from repro_torch.core.executors import run_control
        run_control(prim, ctx)

    def _on_complete(self, task: NodeTask):
        if not task.managed:
            t0 = task.ctx.node_spans.get(task.prim.pid,
                                         (task.t_arrival, None))[0]
            t1 = time.time()
            task.ctx.node_spans[task.prim.pid] = (t0, t1)
            _trace_prim(task, t0, t1)
            return
        self._complete_node(task.prim, task.ctx, task)

    def _complete_node(self, prim: Primitive, ctx: QueryContext,
                       task: Optional[NodeTask] = None):
        t0 = ctx.node_spans.get(prim.pid, (time.time(), None))[0]
        t1 = time.time()
        ctx.node_spans[prim.pid] = (t0, t1)
        if task is not None:
            _trace_prim(task, t0, t1)
        ready = []
        with ctx.lock:
            for cpid in prim.children:
                if (prim.pid, cpid) in ctx.early_edges:
                    continue        # already released on first chunk
                ctx.indegree[cpid] -= 1
                if ctx.indegree[cpid] == 0:
                    ready.append(ctx.graph.nodes[cpid])
        for n in ready:
            self._dispatch(n, ctx)
        # finished when every node has been completed
        if all(v <= 0 for v in ctx.indegree.values()) and \
                all(ctx.node_spans.get(pid, (0, None))[1] is not None
                    for pid in ctx.graph.nodes):
            self._finish(ctx)

    def _finish(self, ctx: QueryContext):
        if ctx.done.is_set():
            return
        ctx.t_done = time.time()
        if ctx.span_id is not None:
            tracing.record("query", tracing.ns(ctx.t_submit),
                           tracing.ns(ctx.t_done), id=ctx.span_id,
                           qid=ctx.qid)
        ctx.done.set()
        if self.overload is not None:
            # feed the admission controller's service-rate estimate
            self.overload.note_query_done(ctx)
        # release LLM sequence state on every replica of every pool
        for name, eng in self.engines.items():
            for inst in replicas_of(eng):
                if hasattr(inst, "release"):
                    for sid in ctx.sids:
                        inst.release(sid)
                if hasattr(inst, "drop"):
                    inst.drop(ctx.qid)
        for s in self.scheds.values():
            if isinstance(s, PooledEngineScheduler):
                s.forget(ctx.qid)

    def shutdown(self):
        """Stop the schedulers, then the replicas' decode loops (a
        scheduler may still start one), and join every thread either
        started, within ``SHUTDOWN_JOIN_S`` in all; raise RuntimeError
        naming each thread still alive after it."""
        deadline = time.monotonic() + SHUTDOWN_JOIN_S
        for s in self.scheds.values():
            s.stop()
        joined: set = set()
        alive: List[str] = []

        def join_new():
            # a joined thread may have started more (a hedge, a retry, an
            # early-release dispatch): repeat until nothing new appears
            while True:
                new = [t for s in self.scheds.values() for t in s.threads()]
                new = [t for t in new + self.aux.threads()
                       if t not in joined]
                if not new:
                    return
                joined.update(new)
                alive.extend(join_threads(new, deadline))

        join_new()
        loops = []
        for eng in self.engines.values():
            for inst in replicas_of(eng):
                if hasattr(inst, "stop_decode_loop"):
                    loop = inst._decode_loop
                    inst.stop_decode_loop()
                    if loop is not None:
                        loops.append(loop)
        alive.extend(join_threads(loops, deadline))
        join_new()
        if alive:
            raise RuntimeError(f"shutdown: {len(alive)} thread(s) still "
                               f"alive after {SHUTDOWN_JOIN_S:.0f} s: "
                               f"{alive}")
