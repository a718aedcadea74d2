"""Engine pools: N replicas of one engine behind a load-aware router.

The paper's testbed provisions two instances per LLM (§7.1) and its
instance-scaling / colocation results depend on dispatching work across
replicas. An ``EnginePool`` owns the replicas (built by ``replicate`` via
each engine's ``clone()`` — model weights are shared, per-replica state
such as the KV store is not) plus the per-replica load ledger the
lower-tier router consults.

The load metric is tokens, not queue length: for each replica it sums
  queued    — token estimate of batches routed to the replica but not
              yet executing,
  inflight  — token estimate of the batch currently executing,
  resident  — KV-cache occupancy (tokens held by live sequences on that
              replica, reported by the engine's ``kv_occupancy()``).
A queue-length metric would treat a 2000-token prefill and an 8-token
judge decode as equal work; token accounting is what makes colocated
heterogeneous apps balance (Fig. 9).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List

from repro_torch.core import primitives as P

# Resident KV tokens cost less than tokens that still need compute: they
# occupy memory and lengthen future attention, but are not queued work.
RESIDENT_WEIGHT = 0.25


def estimate_tokens(prim) -> int:
    """Token-work estimate for routing. Decode work scales with max_new;
    prefill with the (profiled) prompt length; encoder/model-free ops with
    their request count."""
    cfg = prim.config
    if prim.op in (P.DECODE, P.PARTIAL_DECODE):
        return prim.num_requests * int(cfg.get("max_new", 24))
    if prim.op in (P.PREFILL, P.PARTIAL_PREFILL, P.FULL_PREFILL):
        return prim.num_requests * int(cfg.get("est_prompt_tokens", 64))
    return prim.num_requests * 8


class _ReplicaLoad:
    __slots__ = ("queued", "inflight")

    def __init__(self):
        self.queued = 0
        self.inflight = 0


class EnginePool:
    """Replica container + load ledger. The pool is engine-kind agnostic:
    anything exposing the op_* executor interface and (optionally)
    ``clone()`` / ``kv_occupancy()`` can be pooled."""

    def __init__(self, replicas: List[Any], name: str = "",
                 role: str = "unified"):
        if not replicas:
            raise ValueError("EnginePool needs at least one replica")
        if role not in ("prefill", "decode", "unified", "disaggregated"):
            raise ValueError(f"unknown pool role {role!r}")
        self.replicas = list(replicas)
        self.name = name or getattr(replicas[0], "name", "pool")
        # role specialization: "unified" replicas serve both phases (the
        # default — byte-identical to the pre-role pool); "prefill" /
        # "decode" pools serve one phase; DisaggregatedEnginePool mixes
        # both behind one engine name with a migration handoff between
        # them. Every replica is stamped for introspection.
        self.role = role
        for r in self.replicas:
            setattr(r, "pool_role", role)
        self._loads = [_ReplicaLoad() for _ in self.replicas]
        self._lock = threading.Lock()
        # per-replica health (fault tolerance): healthy -> suspect ->
        # dead. All-healthy is the steady state and every health check
        # below reduces to a no-op then — flag-off routing is identical.
        self._health = ["healthy"] * len(self.replicas)
        self._health_reasons: Dict[int, str] = {}

    @classmethod
    def replicate(cls, engine, n: int, name: str = "") -> "EnginePool":
        """Build a pool of `n` replicas from a prototype engine via its
        ``clone()`` (shared weights, fresh per-replica state). The
        prototype itself is replica 0."""
        reps = [engine]
        for i in range(1, n):
            if not hasattr(engine, "clone"):
                raise TypeError(
                    f"{type(engine).__name__} has no clone(); cannot build "
                    f"a pool of {n}")
            reps.append(engine.clone(i))
        return cls(reps, name=name or getattr(engine, "name", ""))

    # -- container protocol -------------------------------------------------
    def __len__(self):
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    def __getitem__(self, i):
        return self.replicas[i]

    # -- load ledger (token units) ------------------------------------------
    def note_queued(self, i: int, tokens: int):
        with self._lock:
            self._loads[i].queued += tokens

    def note_started(self, i: int, tokens: int):
        with self._lock:
            self._loads[i].queued -= tokens
            self._loads[i].inflight += tokens

    def note_finished(self, i: int, tokens: int):
        with self._lock:
            self._loads[i].inflight -= tokens

    # Continuous-batching decodes skip the routed-batch queue: work goes
    # straight into the replica's decode loop, so it is in-flight from
    # submission until the sequence is evicted.
    def note_decode_submitted(self, i: int, tokens: int):
        with self._lock:
            self._loads[i].inflight += tokens

    def note_decode_finished(self, i: int, tokens: int):
        with self._lock:
            self._loads[i].inflight -= tokens

    def load(self, i: int) -> float:
        """Outstanding token-work of replica i (queued + in-flight +
        discounted resident KV occupancy). Paged replicas report
        occupancy in ALLOCATED BLOCKS (block-quantized tokens, shared
        prefixes counted once) — true memory, not amortized tokens."""
        resident = getattr(self.replicas[i], "kv_occupancy", lambda: 0)()
        with self._lock:
            l = self._loads[i]
            return l.queued + l.inflight + RESIDENT_WEIGHT * resident

    def kv_free_blocks(self, i: int):
        """Free (unreserved) paged-KV blocks of replica i; None when the
        replica has no block pool."""
        fn = getattr(self.replicas[i], "kv_free_blocks", None)
        return fn() if fn is not None else None

    # -- replica health (fault tolerance) -----------------------------------
    _HEALTH_ORDER = {"healthy": 0, "suspect": 1, "dead": 2}

    def health(self, i: int) -> str:
        """Effective health of replica i: the worse of the pool's mark
        (detection-side) and the engine's own ``health`` attribute
        (set when its decode loop dies or a crash is injected)."""
        eng = getattr(self.replicas[i], "health", "healthy")
        mine = self._health[i]
        return eng if self._HEALTH_ORDER.get(eng, 0) > \
            self._HEALTH_ORDER.get(mine, 0) else mine

    def health_reason(self, i: int) -> str:
        return self._health_reasons.get(i, "")

    def mark_suspect(self, i: int, reason: str = ""):
        """Quarantine-light: a suspect replica only receives work when
        no healthy candidate remains (demoted in every routing key)."""
        with self._lock:
            if self._health[i] == "healthy":
                self._health[i] = "suspect"
                self._health_reasons[i] = reason

    def mark_dead(self, i: int, reason: str = "") -> bool:
        """Quarantine: a dead replica is excluded from routing entirely.
        Returns True on the healthy/suspect -> dead transition (callers
        reclaim its blocks exactly once)."""
        with self._lock:
            was = self._health[i]
            self._health[i] = "dead"
            if was != "dead":
                # keep the FIRST death reason — later marks are echoes
                self._health_reasons[i] = reason
            return was != "dead"

    def mark_healthy(self, i: int):
        """Re-admit a replica (operator action / tests)."""
        with self._lock:
            self._health[i] = "healthy"
            self._health_reasons.pop(i, None)

    def healthy_indices(self, indices=None) -> list:
        """Candidate set with dead replicas excluded. Falls back to the
        unfiltered set when EVERY candidate is dead — routing then fails
        at submit time with the replica's own error rather than silently
        picking nothing."""
        base = list(indices if indices is not None
                    else range(len(self.replicas)))
        alive = [i for i in base if self.health(i) != "dead"]
        return alive or base

    def _suspect_rank(self, i: int) -> int:
        return 0 if self.health(i) == "healthy" else 1

    def least_loaded(self, indices=None) -> int:
        """Replica for routed batch work. A replica whose paged-KV pool
        is EXHAUSTED only receives work when every replica is exhausted
        (admission backpressure at the routing tier). ``indices``
        restricts the candidate set (role-specialized dispatch); None —
        the default — considers every replica, byte-identical to the
        pre-role router."""
        def key(i):
            free = self.kv_free_blocks(i)
            return (self._suspect_rank(i),
                    0 if (free is None or free > 0) else 1, self.load(i))
        return min(self.healthy_indices(indices), key=key)

    # -- prefix-aware routing (radix prefix cache) --------------------------
    def prefix_match_len(self, i: int, text: str) -> int:
        """Radix-cached prefix length of ``text`` on replica i (0 when
        the replica has no radix cache). Read-only probe."""
        fn = getattr(self.replicas[i], "prefix_match_len", None)
        return fn(text) if fn is not None else 0

    def best_prefix_replica(self, text: str, indices=None):
        """Replica whose radix tree holds the LONGEST cached prefix of
        ``text`` — prefill there reuses the most KV. Exhausted pools are
        demoted exactly like least_loaded; ties (including the common
        no-match-anywhere case) return None so the caller falls back to
        block-aware least-loaded routing. ``indices`` restricts the
        candidate set (role-specialized dispatch)."""
        best_i, best_m = None, 0
        for i in self.healthy_indices(indices):
            if self.health(i) == "dead":
                continue          # all-dead fallback set: no prefix reuse
            free = self.kv_free_blocks(i)
            if free is not None and free <= 0:
                continue
            m = self.prefix_match_len(i, text)
            if m > best_m:
                best_i, best_m = i, m
        return best_i

    # -- slot-aware decode routing (continuous batching) --------------------
    def decode_slots_free(self, i: int):
        """Free decode-loop slots of replica i; None when the replica
        does not expose slot accounting."""
        fn = getattr(self.replicas[i], "decode_slots_free", None)
        return fn() if fn is not None else None

    def _tenant_slots_held(self, i: int, tenant) -> int:
        """Decode slots ``tenant`` currently holds on replica i (0 when
        the replica has no armed SLO policy / slot ledger)."""
        pol = getattr(self.replicas[i], "slo", None)
        if tenant is None or pol is None or \
                getattr(pol, "slots", None) is None:
            return 0
        return pol.slots.usage_of(tenant)

    def least_loaded_decode(self, indices=None, tenant=None) -> int:
        """Replica for a new continuous-batching decode: a replica with a
        free decode slot starts the sequence NEXT iteration, while a full
        loop queues it behind a whole sequence — so free-slot replicas
        win outright; a block-exhausted paged pool demotes a replica the
        same way (its loop would defer admission); ties fall back to
        token load. ``indices`` restricts the candidate set
        (role-specialized dispatch). ``tenant`` (SLO scheduling) spreads
        one tenant's sequences across replicas: among equally-free
        replicas, the one where the tenant holds the fewest decode slots
        wins — per-replica fair-share ledgers then see balanced holdings
        instead of one replica absorbing the whole tenant. ``tenant``
        None (flag off) keeps the key byte-identical."""
        def key(i):
            slots = self.decode_slots_free(i)
            blocks = self.kv_free_blocks(i)
            has_free = (slots is None or slots > 0) and \
                (blocks is None or blocks > 0)
            return (self._suspect_rank(i), 0 if has_free else 1,
                    self._tenant_slots_held(i, tenant), self.load(i))
        return min(self.healthy_indices(indices), key=key)

    def tenant_stats(self) -> Dict[str, dict]:
        """Pool-level per-tenant/per-class stats: replica snapshots
        merged (counts sum; latency percentiles keep the max — a
        conservative pool tail bound). Empty when no replica has an
        armed SLO policy."""
        out: Dict[str, dict] = {}
        for r in self.replicas:
            fn = getattr(r, "tenant_stats", None)
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

    def loads(self) -> List[float]:
        return [self.load(i) for i in range(len(self.replicas))]

    def outstanding_tokens(self) -> float:
        """Total outstanding token-work across the pool (queued +
        in-flight + discounted resident) — the queue-backlog signal the
        overload layer's admission controller reads at the front door."""
        return float(sum(self.loads()))

    def __repr__(self):
        return f"<EnginePool {self.name} x{len(self.replicas)}>"


class DisaggregatedEnginePool(EnginePool):
    """Role-specialized pool: replicas [0, n_prefill) are PREFILL
    specialists, the rest DECODE specialists, behind one engine name.

    Prefill replicas run (chunked or monolithic) prefill at full token
    budget with no co-resident decodes to time-slice against; decode
    replicas run the continuous decode loop with no prompt chunks
    stealing budget. The scheduler's two-stage dispatch routes PREFILL
    ops to the prefill side (prefix-aware, block-aware least-loaded as
    in a unified pool, restricted to ``prefill_indices``) and, when the
    first decode op of a sequence arrives, migrates the sequence's paged
    KV blocks to the chosen decode replica (``export_seq``/``import_seq``
    — the ``migrate_blocks`` handoff) before admitting it into that
    replica's loop. Everything EnginePool provides (load ledger, container
    protocol, registry helpers) applies unchanged — the subclass only
    partitions the candidate sets and records handoffs."""

    def __init__(self, replicas: List[Any], n_prefill: int, name: str = ""):
        if not 1 <= n_prefill < len(replicas):
            raise ValueError(
                f"disaggregated pool needs >=1 prefill and >=1 decode "
                f"replica (got n_prefill={n_prefill} of "
                f"{len(replicas)} replicas)")
        super().__init__(replicas, name=name, role="disaggregated")
        self.n_prefill = n_prefill
        for i, r in enumerate(self.replicas):
            setattr(r, "pool_role",
                    "prefill" if i < n_prefill else "decode")
        self.migrations: List[tuple] = []   # (sid, src_idx, dst_idx)

    @classmethod
    def disaggregate(cls, engine, n_prefill: int, n_decode: int,
                     name: str = "") -> "DisaggregatedEnginePool":
        """Build a prefill/decode-specialized pool from one prototype
        engine (replica 0 is the prototype, a prefill specialist) —
        clones share weights, per-replica KV pools are private exactly
        as in ``replicate``."""
        if n_prefill < 1 or n_decode < 1:
            raise ValueError(
                f"need >=1 prefill and >=1 decode replica, got "
                f"{n_prefill}/{n_decode}")
        if not hasattr(engine, "clone"):
            raise TypeError(
                f"{type(engine).__name__} has no clone(); cannot "
                f"disaggregate")
        reps = [engine] + [engine.clone(i)
                           for i in range(1, n_prefill + n_decode)]
        return cls(reps, n_prefill,
                   name=name or getattr(engine, "name", ""))

    @property
    def prefill_indices(self) -> tuple:
        return tuple(range(self.n_prefill))

    @property
    def decode_indices(self) -> tuple:
        return tuple(range(self.n_prefill, len(self.replicas)))

    def role_of(self, i: int) -> str:
        return "prefill" if i < self.n_prefill else "decode"

    # -- graceful degradation (fault tolerance) -----------------------------
    # When every replica of one role is dead, the pool DEMOTES to
    # colocated mode on the surviving role's replicas: a dead decode
    # side sends decodes to the prefill specialists (and vice versa)
    # rather than stranding the request. All-healthy, these return the
    # static role partitions — flag-off routing is identical.

    def route_prefill_indices(self) -> tuple:
        alive = tuple(i for i in self.prefill_indices
                      if self.health(i) != "dead")
        if alive:
            return alive
        fallback = tuple(i for i in self.decode_indices
                         if self.health(i) != "dead")
        return fallback or self.prefill_indices

    def route_decode_indices(self) -> tuple:
        alive = tuple(i for i in self.decode_indices
                      if self.health(i) != "dead")
        if alive:
            return alive
        fallback = tuple(i for i in self.prefill_indices
                         if self.health(i) != "dead")
        return fallback or self.decode_indices

    def degraded(self) -> bool:
        """True when one whole role is dead and the pool runs colocated."""
        return (all(self.health(i) == "dead" for i in self.decode_indices)
                or all(self.health(i) == "dead"
                       for i in self.prefill_indices))

    def note_migration(self, sid: str, src_idx: int, dst_idx: int):
        with self._lock:
            self.migrations.append((sid, src_idx, dst_idx))

    def __repr__(self):
        return (f"<DisaggregatedEnginePool {self.name} "
                f"{self.n_prefill}p+{len(self.replicas) - self.n_prefill}d>")


# ---------------------------------------------------------------------------
# Registry helpers — an engines-dict value may be a bare engine, a list of
# replicas (legacy), or an EnginePool.

def replicas_of(eng) -> list:
    if isinstance(eng, EnginePool):
        return list(eng.replicas)
    if isinstance(eng, list):
        return list(eng)
    return [eng]


def pool_size(eng) -> int:
    return len(replicas_of(eng))


def primary_of(eng):
    """Representative replica (profile source for EngineSpec)."""
    return replicas_of(eng)[0]


def pair_replicas(target, draft) -> List[tuple]:
    """Draft/target placement for speculative decoding: pair replica i of
    the target pool with replica ``i % len(draft)`` of the draft pool —
    the index-aligned co-location the paper's shared app pool already
    provides (core_llm replica i sits next to lite_llm replica i), cycled
    when the pools are sized differently. Works on bare engines, legacy
    replica lists, and EnginePools."""
    t, d = replicas_of(target), replicas_of(draft)
    return [(t[i], d[i % len(d)]) for i in range(len(t))]


def build_pools(engines: Dict[str, Any],
                sizes: Dict[str, int]) -> Dict[str, Any]:
    """Replace selected engines with pools: sizes maps engine name -> n.
    Engines absent from `sizes` (or with n == 1) pass through untouched."""
    out = dict(engines)
    for name, n in sizes.items():
        if n > 1 and name in out and not isinstance(out[name], EnginePool):
            out[name] = EnginePool.replicate(out[name], n, name=name)
    return out


def disaggregate_pools(engines: Dict[str, Any], names,
                       n_prefill: int, n_decode: int) -> Dict[str, Any]:
    """Replace the named engines with disaggregated prefill/decode pools
    (``--disaggregate`` wiring). Engines already pooled or absent pass
    through untouched."""
    out = dict(engines)
    for name in names:
        if name in out and not isinstance(out[name], EnginePool):
            out[name] = DisaggregatedEnginePool.disaggregate(
                out[name], n_prefill, n_decode, name=name)
    return out
