"""Overload control & graceful degradation for the Teola runtime (a copy
of ``repro/serving/overload.py``; it holds no tensors).

When offered load exceeds capacity, per-module servers can only time out
whole queries. With the e-graph in hand the orchestrator can do better —
this module implements four cooperating mechanisms, all flag-gated and
byte-identical to the unarmed runtime when idle:

1. **Deadline propagation** — a single per-query deadline (unifying the
   fault-tolerance ``request_deadline`` watchdog and ``SLOTag`` urgency)
   is decomposed along the e-graph into per-primitive latest-finish
   budgets using the same critical-path structure ``passes.py`` already
   computes, so every dispatched task knows its slack.
2. **Admission control / load shedding** — a front-door controller
   estimates pool queue delay from ``EnginePool`` load signals plus its
   own in-flight ledger and rejects new queries with a structured
   :class:`Overloaded` error before they consume capacity. The
   interactive class is protected by a configurable headroom factor.
3. **Hedged dispatch** — for idempotent non-LLM primitives (embed,
   rerank, search) the pooled scheduler issues a backup request to a
   second healthy replica after a latency-percentile trigger;
   first-result-wins, the loser is discarded, and a hedge failure is
   never double-counted as a replica failure.
4. **Degraded-mode execution** — per-node degradation annotations
   (skippable rerank, shrinkable ``top_k``, shrinkable ``max_new``,
   prefill chunk caps) are activated stepwise by a brown-out ladder with
   hysteresis whenever measured slack goes negative, with per-query
   attribution in stats.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serving.faults import RequestError
from repro_torch.serving.slo import BATCH, INTERACTIVE


class Overloaded(RequestError):
    """Structured front-door rejection: the query was shed at admission
    because the estimated queue delay exceeded its slack."""

    def __init__(self, msg: str, *, qid: str = "", cls: str = BATCH,
                 outstanding: float = 0.0,
                 est_delay_s: Optional[float] = None):
        super().__init__(msg, qid=qid, reason="overloaded")
        self.cls = cls
        self.outstanding = outstanding
        self.est_delay_s = est_delay_s


def query_class(slo: Optional[str], priority: int) -> str:
    """Same class derivation as ``slo.derive_tag`` (kept in sync)."""
    if slo is not None:
        return slo
    return INTERACTIVE if priority > 0 else BATCH


# Idempotent, sequence-state-free primitive ops that are safe to hedge:
# running them twice produces identical store writes.
HEDGEABLE_OPS = ("Embedding", "Reranking", "Searching", "SearchAPI")


@dataclass
class OverloadConfig:
    """Knobs for the overload-control layer. Every mechanism is off (or
    inert) by default; arming with defaults and zero pressure must be
    token-identical to running without the layer."""
    # -- deadlines (seconds of slack granted at submit; None = no deadline)
    deadline_s: Optional[float] = None
    interactive_deadline_s: Optional[float] = None   # falls back to deadline_s
    batch_deadline_s: Optional[float] = None         # falls back to deadline_s
    # -- admission control / shedding
    shed: bool = False
    max_queue_tokens: float = 4096.0   # shed batch class beyond this backlog
    interactive_factor: float = 3.0    # interactive headroom multiplier
    ewma_alpha: float = 0.2            # service-rate smoothing
    # -- hedged dispatch
    hedge: bool = False
    hedge_after_s: Optional[float] = None  # fixed trigger (deterministic tests)
    hedge_quantile: float = 0.95           # else: latency percentile trigger
    hedge_min_samples: int = 16            # samples before percentile arms
    # -- degradation ladder
    degrade: bool = False
    degrade_after: int = 2     # consecutive negative-slack samples per step up
    recover_after: int = 4     # consecutive positive-slack samples per step down
    cooldown_s: float = 0.5    # min seconds between ladder moves (hysteresis)
    max_level: int = 3


def decompose_deadline(graph) -> Dict[str, float]:
    """Per-primitive latest-finish fractions along the e-graph.

    For each primitive ``p`` let ``cost(p)`` be its estimated token work
    and ``D(p)`` the downstream critical cost — the heaviest
    ``cost + D`` over its children. With ``T`` the total critical-path
    cost, primitive ``p`` must finish by fraction ``(T - D(p)) / T`` of
    the query's total slack for the critical path to stay on schedule.
    Sinks map to 1.0; earlier primitives to proportionally smaller
    fractions. Returns ``{pid: fraction in (0, 1]}``.
    """
    from repro_torch.core.engine_pool import estimate_tokens

    nodes = graph.nodes
    cost = {pid: float(max(1, estimate_tokens(n))) for pid, n in nodes.items()}
    down: Dict[str, float] = {}
    for n in reversed(graph.topo_order()):           # children before parents
        d = 0.0
        for cpid in n.children:
            d = max(d, cost[cpid] + down[cpid])
        down[n.pid] = d
    total = max((cost[pid] + down[pid] for pid in nodes), default=0.0)
    if total <= 0.0:
        return {pid: 1.0 for pid in nodes}
    return {pid: (total - down[pid]) / total for pid in nodes}


def query_token_estimate(graph) -> float:
    """Total estimated token work of a query's e-graph (admission ledger
    unit; control-flow primitives are free)."""
    from repro_torch.core.engine_pool import estimate_tokens
    from repro_torch.core.primitives import CONTROL_OPS

    return float(sum(estimate_tokens(n) for n in graph.nodes.values()
                     if n.op not in CONTROL_OPS))


class AdmissionController:
    """Front-door load shedding.

    The backlog signal is the max of (a) the controller's own in-flight
    token ledger (admitted queries not yet done) and (b) the registered
    ``EnginePool`` load signals (queued + in-flight + discounted-resident
    tokens). A batch-class query is shed when the backlog exceeds
    ``max_queue_tokens`` — or, once a service rate has been observed and
    the query carries a deadline, when the estimated queue delay exceeds
    its slack. Interactive queries get ``interactive_factor`` times the
    headroom; a query whose deadline is already unmeetable is shed
    regardless of class.
    """

    def __init__(self, cfg: OverloadConfig):
        self.cfg = cfg
        self.pools: List[Any] = []
        self._live: List[Tuple[Any, float]] = []     # (ctx, tokens)
        self._rate: Optional[float] = None           # tokens / second
        self._lock = threading.Lock()
        self.counts = {INTERACTIVE: {"admitted": 0, "shed": 0},
                       BATCH: {"admitted": 0, "shed": 0}}

    def register_pool(self, pool) -> None:
        with self._lock:
            if pool not in self.pools:
                self.pools.append(pool)

    # -- signals ----------------------------------------------------------
    def outstanding_tokens(self) -> float:
        with self._lock:
            self._live = [(c, t) for (c, t) in self._live
                          if not c.done.is_set()]
            own = sum(t for _, t in self._live)
            pools = list(self.pools)
        sig = own
        for p in pools:
            try:
                sig = max(sig, p.outstanding_tokens())
            except Exception:  # noqa: BLE001 - a dying pool never blocks admit
                pass
        return float(sig)

    def note_done(self, tokens: float, elapsed_s: float) -> None:
        """Feed one completed query into the EWMA service-rate estimate."""
        if elapsed_s <= 0 or tokens <= 0:
            return
        inst = tokens / elapsed_s
        with self._lock:
            a = self.cfg.ewma_alpha
            self._rate = inst if self._rate is None else (
                a * inst + (1.0 - a) * self._rate)

    @property
    def service_rate(self) -> Optional[float]:
        return self._rate

    def queue_delay_s(self) -> Optional[float]:
        r = self._rate
        if not r:
            return None
        return self.outstanding_tokens() / r

    # -- decisions --------------------------------------------------------
    def decide(self, cls: str, slack_s: Optional[float] = None,
               ) -> Tuple[bool, float, Optional[float]]:
        """Returns ``(admit, outstanding_tokens, est_delay_s)``."""
        out = self.outstanding_tokens()
        rate = self._rate
        delay = (out / rate) if rate else None
        if slack_s is not None and slack_s <= 0.0:
            return False, out, delay   # unmeetable deadline: any class
        allow = self.cfg.max_queue_tokens
        if rate and slack_s is not None:
            # a tight deadline sheds earlier than the static threshold
            allow = min(allow, rate * slack_s)
        if cls == INTERACTIVE:
            allow *= self.cfg.interactive_factor
        return out <= allow, out, delay

    def admit(self, ctx, cls: str, tokens: float,
              slack_s: Optional[float] = None) -> Optional[Overloaded]:
        """Admit (ledger the query, return None) or shed (return the
        structured error without touching the ledger)."""
        if not self.cfg.shed:
            with self._lock:
                self._live.append((ctx, tokens))
                self.counts[cls]["admitted"] += 1
            return None
        ok, out, delay = self.decide(cls, slack_s)
        with self._lock:
            if ok:
                self._live.append((ctx, tokens))
                self.counts[cls]["admitted"] += 1
                return None
            self.counts[cls]["shed"] += 1
        d = f", est delay {delay:.2f}s" if delay is not None else ""
        return Overloaded(
            f"query {ctx.qid} shed at admission: {out:.0f} tokens "
            f"outstanding{d}", qid=ctx.qid, cls=cls, outstanding=out,
            est_delay_s=delay)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            snap = {c: dict(v) for c, v in self.counts.items()}
            snap["service_rate_tps"] = self._rate
        return snap


class HedgePolicy:
    """Latency tracker + trigger + counters for hedged dispatch."""

    def __init__(self, cfg: OverloadConfig):
        self.cfg = cfg
        self._lat: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self.counts = {"issued": 0, "wins": 0, "losses": 0,
                       "rescues": 0, "backup_failures": 0}

    def note_latency(self, op: str, dt: float) -> None:
        with self._lock:
            self._lat.setdefault(op, deque(maxlen=256)).append(dt)

    def trigger_delay(self, op: str) -> Optional[float]:
        """Seconds to wait before issuing the backup, or None to not
        hedge. A fixed ``hedge_after_s`` takes precedence (deterministic
        schedules); otherwise the configured latency quantile, once
        enough samples exist."""
        if not self.cfg.hedge:
            return None
        if self.cfg.hedge_after_s is not None:
            return self.cfg.hedge_after_s
        with self._lock:
            lat = self._lat.get(op)
            if lat is None or len(lat) < self.cfg.hedge_min_samples:
                return None
            xs = sorted(lat)
        i = min(len(xs) - 1, int(self.cfg.hedge_quantile * len(xs)))
        return xs[i]

    def _bump(self, key: str) -> None:
        with self._lock:
            self.counts[key] += 1

    def note_issued(self) -> None:
        self._bump("issued")

    def note_win(self) -> None:
        self._bump("wins")

    def note_loss(self) -> None:
        self._bump("losses")

    def note_rescue(self) -> None:
        """Primary failed but the hedge completed the batch."""
        self._bump("rescues")

    def note_backup_failure(self) -> None:
        """Hedge failed; never counted against the replica or the task."""
        self._bump("backup_failures")

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)


class DegradationPolicy:
    """Brown-out ladder with hysteresis.

    ``note_slack`` feeds measured per-primitive slack; ``degrade_after``
    consecutive negative samples step the ladder up one level,
    ``recover_after`` consecutive positive samples step it down, and no
    move happens within ``cooldown_s`` of the previous one. Level 0 is
    token-identical to the unarmed runtime.

    Ladder semantics (given a node's ``degrade`` annotation):
      L1  shrink ``top_k`` toward ``min_top_k`` (search / rerank)
      L2  skip a ``skippable`` rerank (unscored passthrough truncation)
      L3  halve decode ``max_new`` toward ``min_new``; cap prefill
          chunks at ``chunk_cap``
    """

    def __init__(self, cfg: OverloadConfig):
        self.cfg = cfg
        self.level = 0
        self._neg = 0
        self._pos = 0
        self._t_move = 0.0
        self._lock = threading.Lock()
        self.step_counts: Dict[str, int] = {}
        self._by_query: Dict[str, set] = {}

    def note_slack(self, slack_s: float, now: Optional[float] = None) -> int:
        """Feed one slack sample; returns the (possibly updated) level."""
        now = time.time() if now is None else now
        with self._lock:
            if slack_s < 0.0:
                self._neg += 1
                self._pos = 0
                if (self._neg >= self.cfg.degrade_after
                        and self.level < self.cfg.max_level
                        and now - self._t_move >= self.cfg.cooldown_s):
                    self.level += 1
                    self._neg = 0
                    self._t_move = now
            else:
                self._pos += 1
                self._neg = 0
                if (self._pos >= self.cfg.recover_after
                        and self.level > 0
                        and now - self._t_move >= self.cfg.cooldown_s):
                    self.level -= 1
                    self._pos = 0
                    self._t_move = now
            return self.level

    def plan(self, ann: Optional[Dict[str, Any]],
             config: Dict[str, Any],
             level: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Pure function: overrides for one primitive at one ladder level
        (None when nothing fires — the token-identical case)."""
        lvl = self.level if level is None else level
        if lvl <= 0 or not ann:
            return None
        out: Dict[str, Any] = {}
        if lvl >= 1 and "min_top_k" in ann and "top_k" in config:
            tk = int(config["top_k"])
            new = max(int(ann["min_top_k"]), (tk + 1) // 2)
            if new < tk:
                out["top_k"] = new
        if lvl >= 2 and ann.get("skippable"):
            out["skip"] = True
        if lvl >= 3:
            if "min_new" in ann and "max_new" in config:
                mn = int(config["max_new"])
                new = max(int(ann["min_new"]), mn // 2)
                if new < mn:
                    out["max_new"] = new
            if "chunk_cap" in ann:
                out["chunk_cap"] = int(ann["chunk_cap"])
        return out or None

    def attribute(self, qid: str, steps) -> None:
        """Per-query attribution: record which steps fired for ``qid``."""
        with self._lock:
            got = self._by_query.setdefault(qid, set())
            for s in steps:
                if s not in got:
                    got.add(s)
                    self.step_counts[s] = self.step_counts.get(s, 0) + 1

    def degraded_queries(self) -> Dict[str, set]:
        with self._lock:
            return {q: set(s) for q, s in self._by_query.items()}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"level": self.level,
                    "steps": dict(self.step_counts),
                    "queries_degraded": len(self._by_query)}


class OverloadManager:
    """Bundles config + controllers; one instance per Runtime.

    The runtime stamps admitted queries (``ctx.deadline``,
    ``ctx.budget_frac``, ``ctx.overload``) so downstream layers — the
    executors' degradation hooks, the FT watchdog's unified deadline,
    the SLO urgency test — all read the same clock.
    """

    def __init__(self, cfg: Optional[OverloadConfig] = None):
        self.cfg = cfg or OverloadConfig()
        self.admission = AdmissionController(self.cfg)
        self.hedge = HedgePolicy(self.cfg)
        self.degrade = DegradationPolicy(self.cfg)

    # -- deadline propagation --------------------------------------------
    def deadline_for(self, cls: str) -> Optional[float]:
        if cls == INTERACTIVE and self.cfg.interactive_deadline_s is not None:
            return self.cfg.interactive_deadline_s
        if cls == BATCH and self.cfg.batch_deadline_s is not None:
            return self.cfg.batch_deadline_s
        return self.cfg.deadline_s

    def stamp(self, ctx, graph, cls: str) -> None:
        """Attach deadline + per-primitive budgets to an incoming query."""
        ctx.overload = self
        ctx.slo_cls = cls
        ctx.ov_tokens = query_token_estimate(graph)
        dl = self.deadline_for(cls)
        if dl is not None:
            ctx.deadline = ctx.t_submit + dl
            ctx.budget_frac = decompose_deadline(graph)

    def admit(self, ctx, cls: str) -> Optional[Overloaded]:
        slack = None
        if getattr(ctx, "deadline", None) is not None:
            slack = ctx.deadline - time.time()
        return self.admission.admit(ctx, cls, getattr(ctx, "ov_tokens", 0.0),
                                    slack)

    def task_slack(self, prim, ctx, now: Optional[float] = None,
                   ) -> Optional[float]:
        """Seconds until this primitive's latest-finish budget expires
        (negative = behind schedule), or None without a deadline."""
        dl = getattr(ctx, "deadline", None)
        if dl is None:
            return None
        frac = getattr(ctx, "budget_frac", {}).get(prim.pid, 1.0)
        node_dl = ctx.t_submit + (dl - ctx.t_submit) * frac
        return node_dl - (time.time() if now is None else now)

    # -- degradation hook (called from the executors, per primitive) -----
    def degrade_plan(self, prim, ctx) -> Optional[Dict[str, Any]]:
        if not self.cfg.degrade:
            return None
        slack = self.task_slack(prim, ctx)
        if slack is not None:
            self.degrade.note_slack(slack)
        ann = prim.config.get("degrade")
        plan = self.degrade.plan(ann, prim.config)
        if plan:
            steps = sorted(plan.keys())
            self.degrade.attribute(ctx.qid, steps)
            try:
                ctx.degraded_steps = (
                    getattr(ctx, "degraded_steps", set()) | set(steps))
            except Exception:  # noqa: BLE001
                pass
        return plan

    # -- completion feedback ---------------------------------------------
    def note_query_done(self, ctx) -> None:
        tokens = getattr(ctx, "ov_tokens", 0.0)
        if ctx.t_done is not None and tokens > 0:
            self.admission.note_done(tokens, ctx.t_done - ctx.t_submit)

    def snapshot(self) -> Dict[str, Any]:
        return {"admission": self.admission.snapshot(),
                "hedge": self.hedge.snapshot(),
                "degrade": self.degrade.snapshot()}
