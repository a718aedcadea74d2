"""SLO-aware multi-tenant scheduling policy (Teola §7.2): a copy of
``repro/serving/slo.py`` (it holds no tensors).

Module-level LLM servers see an undifferentiated token stream; the
orchestration layer KNOWS which requests sit on an interactive user's
critical path and which belong to a throughput-bound batch tenant
(PAPER §7.2 sketches exactly this application-supplied priority).  This
module is that knowledge turned into a scheduling policy — a small,
engine-agnostic object (`SLOPolicy`) that the continuous decode loop and
the engines consult at their existing decision points:

  * **priority admission** — waiting decode sequences and chunked-
    prefill jobs are ranked ``(class, -priority, -depth, arrival)``
    instead of FIFO.  ``interactive`` (TTFT/TBT-bound) ranks ahead of
    ``batch`` (throughput-bound); within a class the legacy
    ``QueryContext.priority`` knob orders (so the one knob now governs
    BOTH the legacy ``form_batch`` path and the continuous path);
    e-graph critical-path ``depth`` breaks ties so a query's downstream
    LLM ops inherit urgency.  An **aging bound** promotes a batch item
    to interactive rank after ``aging_s`` seconds so batch never
    starves.

  * **per-tenant fair share** — a `FairShareLedger` computes a weighted
    max-min allocation of decode slots / KV blocks over tenants with
    live demand.  Work-conserving by construction: a tenant may exceed
    its share whenever no OTHER tenant has unmet demand.

  * **paged preemption** — under pressure (an urgent waiter deferred
    while batch sequences are resident) the policy nominates a batch
    victim for evict-to-recompute: the engine frees its KV (paged:
    ``trim_table`` to position 0; dense: drop the per-seq cache), the
    loop re-queues the sequence, and on re-admission the engine rebuilds
    KV by re-prefilling ``prompt + emitted`` — causal attention over the
    same tokens is the same computation, so the continuation is
    token-identical to the unpreempted run (the same argument as PR-8's
    ``recover_decode`` teacher forcing).  A cooldown plus a per-sequence
    preemption cap provide hysteresis so preemption cannot thrash.

Everything is flag-gated: engines without an attached policy
(``engine.slo is None``) run the exact pre-existing FIFO code paths,
byte-identical.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional

INTERACTIVE = "interactive"
BATCH = "batch"


class SLOTag:
    """Per-request scheduling metadata threaded from ``Runtime.submit``
    down to the engine's ``DecodeSeq`` / ``PrefillJob``.

    ``cls`` is the SLO class (`interactive` / `batch`), ``priority`` the
    legacy application priority knob (higher = sooner), ``tenant`` the
    isolation/accounting domain, ``depth`` the primitive's e-graph
    critical-path depth (more downstream work = more urgency),
    ``t_submit`` the query submit time (aging + TTFT baseline) and
    ``deadline`` the absolute query deadline stamped by the overload
    layer (None = no deadline — the pre-overload behavior).
    """

    __slots__ = ("cls", "priority", "tenant", "depth", "t_submit",
                 "deadline")

    def __init__(self, cls: str = BATCH, priority: int = 0,
                 tenant: str = "default", depth: int = 0,
                 t_submit: Optional[float] = None,
                 deadline: Optional[float] = None):
        if cls not in (INTERACTIVE, BATCH):
            raise ValueError(f"unknown SLO class {cls!r} "
                             f"(expected {INTERACTIVE!r} or {BATCH!r})")
        self.cls = cls
        self.priority = int(priority)
        self.tenant = str(tenant)
        self.depth = int(depth)
        self.t_submit = float(t_submit) if t_submit is not None \
            else time.time()
        self.deadline = float(deadline) if deadline is not None else None

    def __repr__(self):
        return (f"<SLOTag {self.cls} tenant={self.tenant} "
                f"prio={self.priority} depth={self.depth}>")


def derive_tag(*, slo: Optional[str] = None, priority: int = 0,
               tenant: str = "default", depth: int = 0,
               t_submit: Optional[float] = None,
               deadline: Optional[float] = None) -> SLOTag:
    """Build a tag from request metadata.  When no explicit SLO class is
    given the legacy ``priority`` knob decides: any positive priority
    means a user is waiting on it (interactive); priority 0 is
    throughput work (batch).  This is the satellite fix for the latent
    priority gap — the knob that already orders legacy ``form_batch``
    now also orders the continuous path, through the same tag."""
    cls = slo if slo is not None else \
        (INTERACTIVE if priority > 0 else BATCH)
    return SLOTag(cls=cls, priority=priority, tenant=tenant, depth=depth,
                  t_submit=t_submit, deadline=deadline)


# --------------------------------------------------------------------------
# fair share
# --------------------------------------------------------------------------
class FairShareLedger:
    """Weighted max-min fair allocator over tenants with live demand.

    ``shares(demand)`` is a pure function of the demand map: it fills
    one unit at a time, always to the unsatisfied tenant with the
    smallest ``(allocated + 1) / weight`` ratio (ties broken by tenant
    name for determinism) — weighted round-robin, the classic
    progressive-filling realization of weighted max-min fairness.  With
    equal weights this is EXACTLY the integer leximin optimum (tested
    against a brute-force oracle in ``tests/test_slo_sched.py``);
    weights skew the fill rate proportionally.  The stateful
    part (``acquire`` / ``release``) tracks what each tenant currently
    HOLDS so admission checks can compare holdings against shares.

    ``may_take`` is work-conserving: when no other tenant has unmet
    demand (demand above its holdings) the requesting tenant may take
    capacity freely — fairness never idles the machine.
    """

    def __init__(self, capacity: int,
                 weights: Optional[Dict[str, float]] = None):
        self.capacity = max(0, int(capacity))
        self.weights = dict(weights or {})
        self.usage: Dict[str, int] = {}
        self._lock = threading.Lock()

    def weight(self, tenant: str) -> float:
        w = float(self.weights.get(tenant, 1.0))
        return w if w > 0 else 1.0

    # -- stateful holdings -------------------------------------------------
    def acquire(self, tenant: str, n: int = 1):
        with self._lock:
            self.usage[tenant] = self.usage.get(tenant, 0) + int(n)

    def release(self, tenant: str, n: int = 1):
        with self._lock:
            left = self.usage.get(tenant, 0) - int(n)
            if left > 0:
                self.usage[tenant] = left
            else:
                self.usage.pop(tenant, None)

    def usage_of(self, tenant: str) -> int:
        with self._lock:
            return self.usage.get(tenant, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.usage)

    # -- pure allocation ---------------------------------------------------
    def shares(self, demand: Dict[str, int]) -> Dict[str, int]:
        """Weighted max-min shares for the given demand map (units)."""
        want = {t: int(d) for t, d in demand.items() if d > 0}
        share = {t: 0 for t in want}
        if not want or self.capacity <= 0:
            return share
        left = self.capacity
        unsat = sorted(want)
        while left > 0 and unsat:
            # progressive filling: one unit to the tenant whose next
            # unit costs the least weighted share
            t = min(unsat, key=lambda u: ((share[u] + 1) / self.weight(u),
                                          u))
            share[t] += 1
            left -= 1
            if share[t] >= want[t]:
                unsat.remove(t)
        return share

    def may_take(self, tenant: str, n: int = 1,
                 demand: Optional[Dict[str, int]] = None) -> bool:
        """Would granting ``tenant`` ``n`` more units respect its
        weighted max-min share under ``demand``?  Work-conserving: always
        True when no other tenant wants more than it holds."""
        n = int(n)
        with self._lock:
            held = self.usage.get(tenant, 0)
            d = {t: int(v) for t, v in (demand or {}).items()}
            d[tenant] = max(d.get(tenant, 0), held + n)
            others_unmet = any(
                t != tenant and v > self.usage.get(t, 0)
                for t, v in d.items())
        if not others_unmet:
            return True
        return held + n <= self.shares(d).get(tenant, 0)


# --------------------------------------------------------------------------
# per-tenant / per-class stats
# --------------------------------------------------------------------------
def _pct(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, int(round(q * (len(ys) - 1)))))
    return ys[i]


class TenantStats:
    """Counters + latency samples keyed by ``(tenant, cls)``."""

    FIELDS = ("submitted", "admitted", "preempted", "evicted", "done")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[tuple, Dict[str, int]] = {}
        self._ttft: Dict[tuple, List[float]] = {}
        self._tbt: Dict[tuple, List[float]] = {}

    def _key(self, tag: SLOTag) -> tuple:
        return (tag.tenant, tag.cls)

    def bump(self, tag: SLOTag, field: str, n: int = 1):
        with self._lock:
            row = self._counts.setdefault(
                self._key(tag), {f: 0 for f in self.FIELDS})
            row[field] = row.get(field, 0) + n

    def note_ttft(self, tag: SLOTag, dt: float):
        with self._lock:
            self._ttft.setdefault(self._key(tag), []).append(float(dt))

    def note_tbt(self, tag: SLOTag, dt: float):
        with self._lock:
            self._tbt.setdefault(self._key(tag), []).append(float(dt))

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            keys = set(self._counts) | set(self._ttft) | set(self._tbt)
            out = {}
            for k in sorted(keys):
                row = dict(self._counts.get(
                    k, {f: 0 for f in self.FIELDS}))
                ttft, tbt = self._ttft.get(k, []), self._tbt.get(k, [])
                row["ttft_p50_ms"] = round(_pct(ttft, 0.50) * 1e3, 3)
                row["ttft_p99_ms"] = round(_pct(ttft, 0.99) * 1e3, 3)
                row["tbt_p50_ms"] = round(_pct(tbt, 0.50) * 1e3, 3)
                row["tbt_p99_ms"] = round(_pct(tbt, 0.99) * 1e3, 3)
                out[f"{k[0]}/{k[1]}"] = row
            return out

    def merge_into(self, out: Dict[str, dict]):
        """Accumulate this replica's snapshot into a pool-level dict."""
        for key, row in self.snapshot().items():
            dst = out.setdefault(key, {})
            for f, v in row.items():
                if f.endswith("_ms"):
                    # percentiles do not sum; keep the max across
                    # replicas (a conservative pool-level tail bound)
                    dst[f] = max(dst.get(f, 0.0), v)
                else:
                    dst[f] = dst.get(f, 0) + v
        return out


# --------------------------------------------------------------------------
# the policy object engines / loops consult
# --------------------------------------------------------------------------
class SLOPolicy:
    """Per-replica scheduling policy: ranking, fair share, preemption.

    Attached to an engine as ``engine.slo`` by :func:`attach_slo`; the
    continuous decode loop and the engine's ``try_admit`` consult it.
    ``slots`` / ``blocks`` are the replica's decode-slot and KV-block
    capacities (0 disables that ledger — e.g. dense engines have no
    block pool)."""

    def __init__(self, *, slots: int = 0, blocks: int = 0,
                 weights: Optional[Dict[str, float]] = None,
                 aging_s: float = 5.0, preempt_cooldown_s: float = 0.25,
                 max_preempts_per_seq: int = 2,
                 deadline_slack_s: float = 1.0):
        self.slots = FairShareLedger(slots, weights) if slots else None
        self.blocks = FairShareLedger(blocks, weights) if blocks else None
        self.aging_s = float(aging_s)
        self.deadline_slack_s = float(deadline_slack_s)
        self.preempt_cooldown_s = float(preempt_cooldown_s)
        self.max_preempts_per_seq = int(max_preempts_per_seq)
        self.stats = TenantStats()
        self._lock = threading.Lock()
        self._t_last_preempt = 0.0
        self._preempt_counts: Dict[str, int] = {}
        # tenants with unmet demand at the loop's last admission pass —
        # the engine-side block-share check uses this as the demand set
        self.live_tenants: frozenset = frozenset()

    # -- tagging / ranking -------------------------------------------------
    def tag_of(self, obj) -> SLOTag:
        """The object's SLO tag; untagged work gets a default batch tag
        stamped with its own submit time (so it still ages)."""
        tag = getattr(obj, "slo", None)
        if tag is None:
            tag = SLOTag(cls=BATCH, t_submit=getattr(
                obj, "t_submit", time.time()))
            try:
                obj.slo = tag
            except Exception:  # noqa: BLE001 — unsettable obj: tag anew
                pass
        return tag

    def is_urgent(self, obj, now: Optional[float] = None) -> bool:
        """Interactive class, batch promoted by the aging bound, or ANY
        class whose unified query deadline (overload layer) is within
        ``deadline_slack_s`` of expiring — urgency and the FT watchdog
        now read the same clock."""
        tag = self.tag_of(obj)
        now = time.time() if now is None else now
        if tag.cls == INTERACTIVE or \
                (self.aging_s > 0 and now - tag.t_submit >= self.aging_s):
            return True
        dl = getattr(tag, "deadline", None)
        return dl is not None and dl - now <= self.deadline_slack_s

    def rank_key(self, obj, now: Optional[float] = None) -> tuple:
        tag = self.tag_of(obj)
        now = time.time() if now is None else now
        return (0 if self.is_urgent(obj, now) else 1,
                -tag.priority, -tag.depth, tag.t_submit)

    def admission_order(self, waiting: Iterable, now: Optional[float]
                        = None) -> list:
        now = time.time() if now is None else now
        return sorted(waiting, key=lambda s: self.rank_key(s, now))

    # -- fair share --------------------------------------------------------
    def slot_demand(self, waiting: Iterable, active: Iterable) \
            -> Dict[str, int]:
        """Per-tenant decode-slot demand: resident + queued."""
        d: Dict[str, int] = {}
        for seq in list(waiting) + list(active):
            t = self.tag_of(seq).tenant
            d[t] = d.get(t, 0) + 1
        return d

    def may_take_slot(self, tag: SLOTag,
                      demand: Dict[str, int]) -> bool:
        if self.slots is None:
            return True
        if self.slots.usage_of(tag.tenant) == 0:
            # progress guarantee: integer shares can round a tenant to
            # ZERO when capacity < live tenants — a tenant holding
            # nothing may always take one free slot (off-by-one-unit
            # from exact max-min, and what keeps a preempted-for tenant
            # from losing the freed slot back to the victim's tenant)
            return True
        return self.slots.may_take(tag.tenant, 1, demand)

    def may_take_blocks(self, tenant: str, n: int) -> bool:
        """Engine-side KV-block share check (called from ``try_admit``).
        Demand set = tenants the loop saw with unmet demand last pass;
        each is assumed able to use its full share (prompt sizes are
        unknown ahead of admission), which degrades to weighted
        proportional shares — still max-min for the saturated case."""
        if self.blocks is None:
            return True
        if self.blocks.usage_of(tenant) == 0:
            # same progress guarantee as slots: a tenant holding no
            # blocks may always admit ONE sequence's worth (its share
            # could otherwise round below a single sequence's need and
            # wedge that tenant out entirely)
            return True
        demand = {t: self.blocks.capacity
                  for t in set(self.live_tenants) | {tenant}}
        return self.blocks.may_take(tenant, n, demand)

    def note_live(self, tenants: Iterable[str]):
        self.live_tenants = frozenset(tenants)

    # -- admission / eviction bookkeeping ---------------------------------
    def note_admit(self, seq):
        tag = self.tag_of(seq)
        if self.slots is not None:
            self.slots.acquire(tag.tenant, 1)
        seq._slo_slot_held = True
        self.stats.bump(tag, "admitted")

    def _drop_slot(self, seq, tag: SLOTag):
        # the held-flag (not t_admit) guards the release: a preempted
        # sequence keeps its t_admit but no longer holds a slot
        if self.slots is not None and getattr(seq, "_slo_slot_held",
                                              False):
            self.slots.release(tag.tenant, 1)
        seq._slo_slot_held = False

    def note_evict(self, seq, failed: bool = False):
        tag = self.tag_of(seq)
        self._drop_slot(seq, tag)
        self.stats.bump(tag, "evicted")
        if not failed:
            self.stats.bump(tag, "done")

    def note_tokens(self, seq, now: Optional[float] = None):
        """Per-pass latency sampling: first token → TTFT from the tag's
        submit time; subsequent tokens → TBT from the previous pass."""
        tag = self.tag_of(seq)
        now = time.time() if now is None else now
        last = getattr(seq, "_slo_t_last", None)
        if last is None:
            self.stats.note_ttft(tag, now - tag.t_submit)
        else:
            self.stats.note_tbt(tag, now - last)
        seq._slo_t_last = now

    # -- preemption governor ----------------------------------------------
    def plan_preemption(self, active: Iterable, now: Optional[float]
                        = None) -> list:
        """Nominate at most ONE batch victim for evict-to-recompute.
        Hysteresis: a cooldown between preemptions plus a per-sequence
        preemption cap — a sequence preempted ``max_preempts_per_seq``
        times runs to completion, so pressure cannot thrash the same
        work forever.  Victim choice: the non-urgent resident with the
        fewest emitted tokens (cheapest replay), ties to the most
        recently admitted (LIFO — longest-resident work is safest)."""
        now = time.time() if now is None else now
        with self._lock:
            if now - self._t_last_preempt < self.preempt_cooldown_s:
                return []
            cands = [s for s in active
                     if not self.is_urgent(s, now)
                     and self._preempt_counts.get(s.sid, 0)
                     < self.max_preempts_per_seq]
            if not cands:
                return []
            victim = min(cands, key=lambda s: (s.steps,
                                               -(s.t_admit or 0.0)))
            self._t_last_preempt = now
            self._preempt_counts[victim.sid] = \
                self._preempt_counts.get(victim.sid, 0) + 1
        return [victim]

    def note_preempted(self, seq):
        tag = self.tag_of(seq)
        self._drop_slot(seq, tag)
        self.stats.bump(tag, "preempted")

    # -- reporting ---------------------------------------------------------
    def tenant_stats(self) -> Dict[str, dict]:
        out = self.stats.snapshot()
        if self.blocks is not None:
            held = self.blocks.snapshot()
            for key in out:
                out[key]["kv_blocks_held"] = held.get(
                    key.split("/", 1)[0], 0)
        return out


# --------------------------------------------------------------------------
# wiring
# --------------------------------------------------------------------------
def _decode_replicas(obj) -> list:
    """Expand an engine-or-pool into its decode-capable replicas."""
    reps = getattr(obj, "replicas", None)
    if reps is None:
        reps = list(obj) if isinstance(obj, list) else [obj]
    return [r for r in reps if hasattr(r, "submit_decode")
            and hasattr(r, "max_batch")]


def attach_slo(engines, *, weights: Optional[Dict[str, float]] = None,
               aging_s: float = 5.0, preempt_cooldown_s: float = 0.25,
               max_preempts_per_seq: int = 2,
               deadline_slack_s: float = 1.0) -> list:
    """Arm SLO scheduling on every decode-capable replica in ``engines``
    (a name→engine/pool mapping, as built by ``apps.build_engines`` /
    ``build_sim_engines``).  Each replica gets its OWN policy — slot and
    block ledgers are per-replica resources.  Returns the policies."""
    policies = []
    seen = set()
    for obj in engines.values():
        for rep in _decode_replicas(obj):
            if id(rep) in seen:
                continue
            seen.add(id(rep))
            blocks = int(getattr(rep, "num_blocks", 0) or 0) \
                if getattr(rep, "paged", False) else 0
            pol = SLOPolicy(
                slots=int(getattr(rep, "max_batch", 0) or 0),
                blocks=blocks, weights=weights, aging_s=aging_s,
                preempt_cooldown_s=preempt_cooldown_s,
                max_preempts_per_seq=max_preempts_per_seq,
                deadline_slack_s=deadline_slack_s)
            rep.slo = pol
            policies.append(pol)
    return policies


def pool_tenant_stats(engines) -> Dict[str, dict]:
    """Merge per-replica tenant stats across a name→engine/pool mapping
    (counts sum; latency percentiles keep the per-replica max)."""
    out: Dict[str, dict] = {}
    for obj in engines.values():
        fn = getattr(obj, "tenant_stats", None)
        if fn is None:
            continue
        for key, row in fn().items():
            dst = out.setdefault(key, {})
            for f, v in row.items():
                if f.endswith("_ms"):
                    dst[f] = max(dst.get(f, 0.0), v)
                else:
                    dst[f] = dst.get(f, 0) + v
    return out
