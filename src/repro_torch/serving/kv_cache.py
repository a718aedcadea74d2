"""KV cache management (PyTorch counterpart of
``repro/serving/kv_cache.py``): the dense per-sequence caches and the
block-paged pool with its allocator and radix prefix cache.

Cache layout mirrors the model's stage/pattern structure:

    cache = {
      'stages': [ [elem_cache, ...pattern elems], ...stages ],
    }

where each ``elem_cache`` is a dict of tensors with a leading ``repeat``
dim (stacked across the layers of the stage):

  - GQA attention:      {'k': (R,B,T,K,hd), 'v': (R,B,T,K,hd)}
  - sliding window:     same, a ring buffer of T = min(window + chunk,
                        max_len) slots (rounded up to 256)
  - MLA:                {'ckv': (R,B,T,r), 'krope': (R,B,T,p)}
  - hybrid (attn+ssm):  the attention part plus {'ssm_h': (R,B,dI,N),
                        'ssm_conv': (R,B,cw-1,dI)}
  - rwkv:               {'state': (R,B,H,hd,hd), 'sx_tm': (R,B,d),
                        'sx_cm': (R,B,d)}

Attention caches are stored in bfloat16, recurrent state in float32
(its size does not depend on ``max_len``).

Sequence length is a per-sequence position ``pos`` passed to the model
(all layers advance in lockstep). Unlike the functional reference, the
writes here update the cache tensors IN PLACE (the engine owns every
buffer it passes in) and return them. The paged pool is written in place
too: ``copy_pool_blocks`` copies blocks inside the pool instead of
returning a new one.

The allocator, the radix tree, the block-mode occupancy meter and
dead-replica reclamation (``reclaim_replica``) are copies of the
reference's pure-Python code. Block migration between pools
(``gather_pool_blocks``, ``scatter_pool_blocks``, ``migrate_blocks``)
stages blocks out with ``index_select`` and lands them with
``index_copy_``, in place.
"""
from __future__ import annotations

import threading
import time
from typing import Dict

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig

KV_DTYPE = torch.bfloat16


def elem_cache_shape(cfg: ModelConfig, spec: LayerSpec, repeat: int,
                     batch: int, max_len: int, chunk: int = 256):
    """Returns {name: (shape, dtype)} for one pattern element.

    Sliding-window layers get a ring buffer of `window + chunk` slots
    (capped at max_len): a chunked write of S tokens needs window+S-1
    live slots for every query in the chunk to see its full window."""
    if spec.kind == "rwkv":
        s = cfg.ssm
        heads = cfg.d_model // s.head_dim
        return {"state": ((repeat, batch, heads, s.head_dim, s.head_dim),
                          torch.float32),
                "sx_tm": ((repeat, batch, cfg.d_model), torch.float32),
                "sx_cm": ((repeat, batch, cfg.d_model), torch.float32)}
    out = {}
    if spec.window is None:
        T = max_len
    else:
        T = min(-(-(spec.window + chunk) // 256) * 256, max_len)
    if cfg.attention_kind == "mla":
        m = cfg.mla
        out["ckv"] = ((repeat, batch, T, m.kv_lora_rank), KV_DTYPE)
        out["krope"] = ((repeat, batch, T, m.qk_rope_head_dim), KV_DTYPE)
    else:
        shape = (repeat, batch, T, cfg.num_kv_heads, cfg.resolved_head_dim)
        out["k"] = (shape, KV_DTYPE)
        out["v"] = (shape, KV_DTYPE)
    if spec.kind == "hybrid":
        s, d_inner = cfg.ssm, cfg.d_model
        out["ssm_h"] = ((repeat, batch, d_inner, s.state_dim), torch.float32)
        out["ssm_conv"] = ((repeat, batch, s.conv_dim - 1, d_inner),
                           torch.float32)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               chunk: int = 256, device="cuda", mesh=None):
    """chunk: largest prefill chunk the caller will write (sizes the
    sliding-window ring buffers). Under ``mesh`` (default: the active
    mesh, if any) each array is this rank's slice of the global batch's
    cache, by ``launch/shard_rules.py::cache_spec`` (on the meta device:
    its shape only): the sequence over 'model' (or ('data', 'model') when
    the batch does not divide), RWKV's state over heads and the Mamba
    state over dI where the rules put 'model' there. The model is then
    called with ``cache_batch=batch``."""
    from repro_torch.models.sharding import active_mesh, local_shape
    mesh = active_mesh() if mesh is None else mesh
    if mesh is not None:
        from repro_torch.launch.shard_rules import cache_spec
    stages = []
    for st in cfg.stages:
        elems = []
        for spec in st.pattern:
            shapes = elem_cache_shape(cfg, spec, st.repeat, batch, max_len,
                                      chunk)
            if mesh is not None:
                shapes = {n: (local_shape(shape, cache_spec(
                    n, shape, mesh, batch=batch), mesh), dtype)
                    for n, (shape, dtype) in shapes.items()}
            elems.append({name: torch.zeros(shape, dtype=dtype,
                                            device=device)
                          for name, (shape, dtype) in shapes.items()})
        stages.append(elems)
    return {"stages": stages}


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int,
                chunk: int = 256) -> int:
    total = 0
    for st in cfg.stages:
        for spec in st.pattern:
            for shape, dtype in elem_cache_shape(
                    cfg, spec, st.repeat, batch, max_len, chunk).values():
                n = 1
                for s in shape:
                    n *= s
                total += n * dtype.itemsize
    return total


# ---------------------------------------------------------------------------
# Paged KV pool (block-granular cache with copy-on-write prefix sharing)
#
# Instead of one dense (R,B,max_len,...) cache per sequence, a replica owns
# ONE physical pool per cache array, carved into fixed-size token blocks:
#
#     k: (R, num_blocks, block_size, K, hd)
#
# Every sequence holds a *block table* — a host-side list of physical block
# ids covering its logical positions [0, pos) — instead of a private cache
# pytree. Admission/eviction never stacks or unstacks KV; forking a prefix
# state is O(table) refcount bumps (copy-on-write: a shared block is copied
# only when a writer appends into it). Blocks are refcounted and free-listed
# by BlockAllocator; block 0 is RESERVED as the batch-padding scratch block
# (padding rows write there, so it is never handed to a sequence).

PAD_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The paged KV pool has no free block (admission backpressure)."""


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` fixed-size blocks.

    Block ``PAD_BLOCK`` (0) is reserved for batch-padding writes and is
    never allocated. All methods are thread-safe; ``wait_for_free`` blocks
    until at least ``n`` blocks are free (a ``decref`` to zero notifies),
    which is the prefill-side backpressure point when the pool is full.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the pad block)")
        self.num_blocks = num_blocks
        self._refs = [0] * num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))   # pop() -> low ids
        self._cv = threading.Condition()
        self._waiters = 0

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the reserved pad block)."""
        return self.num_blocks - 1

    def alloc(self) -> int:
        with self._cv:
            if not self._free:
                raise OutOfBlocks(
                    f"paged KV pool exhausted ({self.capacity} blocks)")
            b = self._free.pop()
            self._refs[b] = 1
            return b

    def incref(self, b: int):
        with self._cv:
            assert self._refs[b] > 0, f"incref on free block {b}"
            self._refs[b] += 1

    def decref(self, b: int):
        with self._cv:
            assert self._refs[b] > 0, f"decref on free block {b}"
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)
            if self._refs[b] <= 1:
                # 0: a block returned to the free list; 1: a block held
                # by a radix prefix cache lost its last live-sequence
                # reference and became EVICTABLE capacity — both improve
                # wait_for_free predicates that credit evictable blocks
                self._cv.notify_all()

    def refcount(self, b: int) -> int:
        with self._cv:
            return self._refs[b]

    def refs_snapshot(self) -> list:
        """Copy of the refcount array. Safe to call from a
        ``wait_for_free`` predicate: the condition's underlying lock is
        reentrant, so the waiting thread may re-enter here."""
        with self._cv:
            return list(self._refs)

    def notify_waiters(self):
        """Wake wait_for_free waiters whose predicate improved for a
        reason other than a decref — e.g. a decode RESERVATION was
        dropped (evicted sequence), freeing headroom without freeing a
        block."""
        with self._cv:
            self._cv.notify_all()

    def free_blocks(self) -> int:
        with self._cv:
            return len(self._free)

    def used_blocks(self) -> int:
        with self._cv:
            return self.capacity - len(self._free)

    def waiters(self) -> int:
        """Threads currently blocked in ``wait_for_free`` (diagnostics)."""
        with self._cv:
            return self._waiters

    def snapshot(self) -> dict:
        """Point-in-time allocator state for diagnostics messages."""
        with self._cv:
            return {"capacity": self.capacity,
                    "free": len(self._free),
                    "used": self.capacity - len(self._free),
                    "waiters": self._waiters}

    def audit(self) -> dict:
        """Conservation check: every block is either free (ref 0) or
        referenced; free-list and refcount array must agree exactly.
        Returns {"ok", "leaked", "free", "capacity", "bad_free"}."""
        with self._cv:
            free_set = set(self._free)
            bad_free = [b for b in free_set if self._refs[b] != 0]
            leaked = [b for b in range(1, self.num_blocks)
                      if self._refs[b] == 0 and b not in free_set]
            return {"ok": not bad_free and not leaked,
                    "leaked": len(leaked), "bad_free": len(bad_free),
                    "free": len(self._free), "capacity": self.capacity}

    def wait_for_free(self, n: int, timeout: float = 30.0,
                      reserved_fn=None) -> bool:
        """Block until ``n`` blocks are free beyond ``reserved_fn()``
        (blocks promised to admitted decodes). Returns False on timeout."""
        deadline = time.time() + timeout
        with self._cv:
            self._waiters += 1
            try:
                while True:
                    reserved = reserved_fn() if reserved_fn else 0
                    if len(self._free) - reserved >= n:
                        return True
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return False
                    self._cv.wait(timeout=remaining)
            finally:
                self._waiters -= 1


def blocks_for(pos_end: int, block_size: int) -> int:
    """Blocks needed to cover logical positions [0, pos_end)."""
    return -(-pos_end // block_size)


def trim_table(alloc: "BlockAllocator", table, pos_end: int,
               block_size: int) -> int:
    """Speculative-decode rollback: drop trailing block-table entries
    that cover ONLY positions >= pos_end (rejected draft tokens /
    overshoot), decref'ing each — a shared trailing block is released,
    an exclusively-owned one returns to the free list. Mutates ``table``
    in place and returns the number of entries dropped. Caller must hold
    the engine's paged lock."""
    keep = blocks_for(pos_end, block_size)
    dropped = 0
    while len(table) > keep:
        alloc.decref(table.pop())
        dropped += 1
    return dropped


# ---------------------------------------------------------------------------
# Global radix-tree prefix cache (cross-query / cross-tenant KV reuse)

class _RadixNode:
    """One radix-tree edge: a BLOCK-ALIGNED token run plus the physical
    blocks holding its KV. Children are keyed by the token tuple of
    their first block — two children of one node always differ within
    that first block (otherwise insert would have shared it), so the
    key is collision-free without per-token child maps."""
    __slots__ = ("tokens", "blocks", "children", "parent", "last_access")

    def __init__(self, tokens, blocks, parent):
        self.tokens = tuple(tokens)
        self.blocks = list(blocks)
        self.children: dict = {}
        self.parent = parent
        self.last_access = 0


def _common_len(a, b) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class RadixPrefixCache:
    """Radix tree over TOKEN SEQUENCES whose edges own refcounted paged
    block runs — the generalization of the instruction-prefix cache:
    ANY two requests (any query, any tenant) sharing a block-aligned
    token prefix share its KV blocks, not just prompts starting with a
    warmed instruction.

    Ownership model — the tree is just another block OWNER on the
    engine's ``BlockAllocator``:

      * ``insert`` increfs every newly adopted block (the tree holds
        exactly ONE reference per cached block, deduplicating repeat
        inserts of an already-cached path),
      * ``match_prefix`` increfs the matched run on the CALLER's behalf
        — the caller extends a sequence's block table with them exactly
        like ``fork_state``, and releases them through the normal
        table decref path,
      * ``evict`` walks LRU leaves and drops the tree's references; a
        block still referenced by a live sequence survives its leaf's
        eviction (refcount > 0), so eviction can never free live KV.

    Everything is block-granular: only WHOLE blocks are cached or
    matched (a partial tail block stays exclusively owned by the
    sequence that wrote it), so a matched sequence's first write lands
    on a fresh block and never COWs cached state.

    Thread safety: all tree mutation runs under one internal lock,
    taken BEFORE any allocator call (lock order: radix -> allocator —
    the allocator never calls back). ``_blocks``, the flat mirror of
    every cached block id, is REBOUND (never mutated in place) so
    lock-free readers — the engine's evictable-capacity snapshot in
    routing and wait predicates — can iterate a consistent list."""

    def __init__(self, alloc: BlockAllocator, block_size: int):
        self.alloc = alloc
        self.block_size = int(block_size)
        self._root = _RadixNode((), [], None)
        self._blocks: list = []         # flat mirror of all cached blocks
        self._clock = 0                 # LRU timestamps (monotone counter)
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "hit_tokens": 0,
                      "inserted_blocks": 0, "evicted_blocks": 0,
                      "freed_blocks": 0, "evictions": 0}

    # -- introspection ------------------------------------------------------
    def num_blocks(self) -> int:
        return len(self._blocks)

    def block_snapshot(self) -> list:
        """Current mirror list (lock-free: the list object is immutable
        once published; mutation rebinds)."""
        return self._blocks

    def num_nodes(self) -> int:
        with self._lock:
            n, stack = 0, [self._root]
            while stack:
                node = stack.pop()
                n += len(node.children)
                stack.extend(node.children.values())
            return n

    def evictable_blocks(self) -> int:
        """Cached blocks the tree is the SOLE owner of (refcount 1) —
        the capacity eviction could return to the free list."""
        with self._lock:
            return sum(1 for b in self._blocks
                       if self.alloc.refcount(b) == 1)

    def clear(self) -> int:
        """Drop EVERY cached reference and reset the tree (dead-replica
        reclamation). Returns the number of references released. Blocks
        still shared with live sequences survive until those release."""
        with self._lock:
            n, stack = 0, [self._root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                for b in node.blocks:
                    self.alloc.decref(b)
                    n += 1
            self._root = _RadixNode((), [], None)
            self._blocks = []               # rebind, no mutate
            self.stats["evicted_blocks"] += n
            return n

    # -- match --------------------------------------------------------------
    def _match_locked(self, tokens, touch: bool):
        bs = self.block_size
        toks = tuple(tokens)
        node = self._root
        out, matched = [], 0
        if touch:
            self._clock += 1
            node.last_access = self._clock
        while len(toks) - matched >= bs:
            rest = toks[matched:]
            child = node.children.get(rest[:bs])
            if child is None:
                break
            take = (_common_len(child.tokens, rest) // bs) * bs
            if touch:
                child.last_access = self._clock
            out.extend(child.blocks[: take // bs])
            matched += take
            if take < len(child.tokens):
                break
            node = child
        return out, matched

    def match_prefix(self, tokens):
        """Longest cached block-aligned prefix of ``tokens`` ->
        (block_ids, matched_token_count). Every returned block is
        increfed on the CALLER's behalf: the caller owns a table
        reference (fork semantics) and releases it through the normal
        sequence-release decref path. Touches the matched path's LRU
        timestamps."""
        with self._lock:
            out, matched = self._match_locked(tokens, touch=True)
            for b in out:
                self.alloc.incref(b)
            if matched:
                self.stats["hits"] += 1
                self.stats["hit_tokens"] += matched
            else:
                self.stats["misses"] += 1
            return out, matched

    def match_len(self, tokens) -> int:
        """Read-only probe (router prefix affinity): matched token count
        without increfs or LRU touches."""
        with self._lock:
            return self._match_locked(tokens, touch=False)[1]

    # -- insert -------------------------------------------------------------
    def insert(self, tokens, table) -> int:
        """Cache a finished prompt's block-aligned prefix: walk the tree
        reusing already-cached nodes (a duplicate insert adopts
        nothing), split mid-edge at the last shared block boundary, and
        adopt the new suffix blocks from ``table`` with one tree incref
        each. Returns the number of newly cached blocks."""
        bs = self.block_size
        toks = tuple(tokens[: (len(tokens) // bs) * bs])
        if not toks:
            return 0
        with self._lock:
            self._clock += 1
            self._root.last_access = self._clock
            node, off, added = self._root, 0, 0
            while off < len(toks):
                rest = toks[off:]
                child = node.children.get(rest[:bs])
                if child is None:
                    nb = list(table[off // bs: off // bs + len(rest) // bs])
                    for b in nb:
                        self.alloc.incref(b)
                    new = _RadixNode(rest, nb, node)
                    new.last_access = self._clock
                    node.children[rest[:bs]] = new
                    self._blocks = self._blocks + nb     # rebind, no mutate
                    added = len(nb)
                    break
                take = (_common_len(child.tokens, rest) // bs) * bs
                child.last_access = self._clock
                if take < len(child.tokens):
                    self._split_locked(child, take)
                node = child
                off += take
            self.stats["inserted_blocks"] += added
            return added

    def _split_locked(self, node: _RadixNode, take: int):
        """Split an edge at block boundary ``take``: ``node`` keeps the
        first ``take`` tokens/blocks; a new child inherits the remainder
        and node's former children. No refcounts change — the tree's
        single reference per block just moves between nodes."""
        bs = self.block_size
        lower = _RadixNode(node.tokens[take:], node.blocks[take // bs:],
                           node)
        lower.children = node.children
        for ch in lower.children.values():
            ch.parent = lower
        lower.last_access = node.last_access
        node.tokens = node.tokens[:take]
        node.blocks = node.blocks[:take // bs]
        node.children = {lower.tokens[:bs]: lower}

    # -- eviction -----------------------------------------------------------
    def evict(self, want: int) -> int:
        """LRU leaf eviction under memory pressure: drop least-recently-
        matched leaves until ``want`` blocks have actually RETURNED to
        the free list, or nothing more can free. Leaves whose blocks are
        all still referenced by live sequences are skipped — dropping
        them frees nothing (refcounts keep live KV safe regardless) and
        ancestors of a fully-shared leaf are fully shared too, so
        skipping never strands freeable inner blocks. Evicting a leaf
        can expose its parent as the next LRU leaf (cascade). Returns
        blocks freed to the pool."""
        if want <= 0:
            return 0
        with self._lock:
            freed, evicted_any, skipped = 0, False, set()
            while freed < want:
                leaf = self._lru_leaf_locked(skipped)
                if leaf is None:
                    break
                if not any(self.alloc.refcount(b) == 1
                           for b in leaf.blocks):
                    skipped.add(id(leaf))
                    continue
                for b in leaf.blocks:
                    if self.alloc.refcount(b) == 1:
                        freed += 1
                    self.alloc.decref(b)
                del leaf.parent.children[leaf.tokens[:self.block_size]]
                self.stats["evicted_blocks"] += len(leaf.blocks)
                self.stats["evictions"] += 1
                evicted_any = True
            if evicted_any:
                self._rebuild_mirror_locked()
                self.stats["freed_blocks"] += freed
            return freed

    def _lru_leaf_locked(self, skipped):
        best, stack = None, [self._root]
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n is not self._root and id(n) not in skipped:
                if best is None or n.last_access < best.last_access:
                    best = n
        return best

    def _rebuild_mirror_locked(self):
        blocks, stack = [], [self._root]
        while stack:
            n = stack.pop()
            blocks.extend(n.blocks)
            stack.extend(n.children.values())
        self._blocks = blocks                # rebind, no mutate


def reclaim_replica(engine, lock_timeout: float = 2.0) -> dict:
    """Release every sequence, cached prefix and decode reservation of a
    DEAD replica and audit its allocator for leaks (free-list / refcount
    conservation). Works on real and sim engines (sim has no allocator;
    only the sequence table is dropped).

    A replica that died while HUNG may hold its paged pool lock forever;
    rather than deadlocking the recovery path, its blocks are written
    off (``written_off=True``) — the pool is per-replica, so the leak is
    contained to memory the dead replica owned anyway."""
    report = {"engine": getattr(engine, "name", "?"), "released": 0,
              "radix_refs": 0, "prefix_refs": 0, "leaked": -1,
              "ok": True, "written_off": False}
    paged = bool(getattr(engine, "paged", False))
    plock = getattr(engine, "_paged_lock", None)
    if paged and plock is not None:
        # probe only: if a hung thread holds the pool lock, releasing
        # block tables would block forever — write the pool off instead.
        # (release() takes engine._lock before _paged_lock; holding the
        # paged lock across release() here would invert that order.)
        if not plock.acquire(timeout=lock_timeout):
            report["written_off"] = True
            report["ok"] = False
            return report
        plock.release()
    for sid in list(getattr(engine, "states", {})):
        try:
            engine.release(sid)
            report["released"] += 1
        except Exception:  # noqa: BLE001 — reclaim everything we can
            pass
    radix = getattr(engine, "radix", None)
    if radix is not None:
        report["radix_refs"] = radix.clear()
    pc = getattr(engine, "prefix_cache", None)
    alloc = getattr(engine, "alloc", None)
    if paged and isinstance(pc, dict) and alloc is not None:
        for st in pc.values():
            for b in getattr(st, "table", []) or []:
                alloc.decref(b)
                report["prefix_refs"] += 1
        pc.clear()
    resv = getattr(engine, "_decode_reserved", None)
    if resv is not None:
        resv.clear()
    if paged and alloc is not None:
        audit = alloc.audit()
        report["leaked"] = alloc.capacity - alloc.free_blocks()
        report["ok"] = audit["ok"] and report["leaked"] == 0
        alloc.notify_waiters()
    else:
        report["leaked"] = 0
    return report


def _paged_elem_shape(cfg: ModelConfig, spec: LayerSpec, repeat: int,
                      num_blocks: int, block_size: int):
    """Per-elem pool shapes: the token axis (T) of the dense layout becomes
    (num_blocks, block_size). Sliding-window layers are paged LINEARLY —
    the window is enforced by the position mask, not a ring buffer — so
    every attention elem pages identically. Recurrent state (rwkv /
    hybrid-SSM) is per-sequence, not per-token, and cannot be paged."""
    if spec.kind in ("rwkv", "hybrid"):
        raise ValueError(
            f"paged KV cache does not support '{spec.kind}' layers "
            "(recurrent state is per-sequence, not per-token)")
    if cfg.attention_kind == "mla":
        m = cfg.mla
        return {"ckv": ((repeat, num_blocks, block_size, m.kv_lora_rank),
                        KV_DTYPE),
                "krope": ((repeat, num_blocks, block_size,
                           m.qk_rope_head_dim), KV_DTYPE)}
    hd = cfg.resolved_head_dim
    shape = (repeat, num_blocks, block_size, cfg.num_kv_heads, hd)
    return {"k": (shape, KV_DTYPE), "v": (shape, KV_DTYPE)}


def init_paged_pool(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                    device="cuda"):
    """Physical block pool tree (mirrors init_cache's stage structure,
    with the token axis carved into (num_blocks, block_size)), bf16 zeros
    on ``device``."""
    stages = []
    for st in cfg.stages:
        elems = []
        for spec in st.pattern:
            shapes = _paged_elem_shape(cfg, spec, st.repeat, num_blocks,
                                       block_size)
            elems.append({name: torch.zeros(shape, dtype=dtype,
                                            device=device)
                          for name, (shape, dtype) in shapes.items()})
        stages.append(elems)
    return {"stages": stages}


def paged_block_bytes(cfg: ModelConfig, block_size: int) -> int:
    """True memory of ONE pool block across all layers — the unit the
    block-based OccupancyMeter reports."""
    total = 0
    for st in cfg.stages:
        for spec in st.pattern:
            for shape, dtype in _paged_elem_shape(
                    cfg, spec, st.repeat, 1, block_size).values():
                n = 1
                for s in shape:
                    n *= s
                total += n * dtype.itemsize
    return total


def copy_pool_blocks(pool, srcs, dsts):
    """Copy-on-write realization: duplicate physical blocks ``srcs[i]``
    into ``dsts[i]`` across every pool array, IN PLACE (block axis is axis
    1, after the repeat axis), and return the same pool. ``srcs`` and
    ``dsts`` are disjoint by contract, so the gathered right-hand side is
    never overwritten while it is read.

    Contract: this is a PURE DATA MOVE with no refcount side effects.
    The caller owns all ``BlockAllocator`` bookkeeping — ``dsts`` must
    already be allocated (refcounted) and any decref of ``srcs`` happens
    after the copy."""
    if set(srcs) & set(dsts):
        raise ValueError(f"copy_pool_blocks: srcs {srcs} and dsts {dsts} "
                         f"overlap")
    arrays = _pool_arrays(pool)
    s = torch.as_tensor(srcs, dtype=torch.long, device=arrays[0].device)
    d = torch.as_tensor(dsts, dtype=torch.long, device=arrays[0].device)
    with torch.inference_mode():
        for a in arrays:
            a[:, d] = a[:, s]
    return pool


def _pool_arrays(pool) -> list:
    return [a for elems in pool["stages"] for elem in elems
            for a in elem.values()]


def gather_pool_blocks(pool, blocks):
    """Copy blocks out of ``pool`` into a free-standing staged tree (same
    structure, block axis shrunk to ``len(blocks)``): one ``index_select``
    per pool array. No refcount side effects; the pool is only read, so
    its owner keeps serving from it."""
    idx = torch.as_tensor(blocks, dtype=torch.long,
                          device=_pool_arrays(pool)[0].device)
    with torch.inference_mode():
        return {"stages": [[{name: a.index_select(1, idx)
                             for name, a in elem.items()}
                            for elem in elems] for elems in pool["stages"]]}


def scatter_pool_blocks(pool, stage, blocks):
    """Write a staged tree (from ``gather_pool_blocks``) into slots
    ``blocks`` of ``pool``, IN PLACE (``index_copy_`` per pool array), and
    return the same pool. No refcount side effects."""
    arrays = _pool_arrays(pool)
    idx = torch.as_tensor(blocks, dtype=torch.long, device=arrays[0].device)
    with torch.inference_mode():
        for a, st in zip(arrays, _pool_arrays(stage)):
            a.index_copy_(1, idx, st)
    return pool


def reserve_blocks(alloc: "BlockAllocator", n: int) -> list:
    """All-or-nothing allocation of ``n`` blocks (each refcount 1). If
    the pool runs out mid-way, every block already taken is returned and
    ``OutOfBlocks`` propagates — the allocator is left exactly as found."""
    got: list = []
    try:
        for _ in range(n):
            got.append(alloc.alloc())
    except OutOfBlocks:
        for b in got:
            alloc.decref(b)
        raise
    return got


def migrate_blocks(src_alloc: "BlockAllocator", src_pool,
                   dst_alloc: "BlockAllocator", dst_pool,
                   table, *, dst_table=None):
    """Paged KV handoff: copy the blocks of one sequence's ``table`` from
    a source pool into blocks reserved in a DESTINATION pool (another
    replica), IN PLACE, returning ``(dst_table, dst_pool)``. Built on the
    ``copy_pool_blocks`` contract: the data move itself has no refcount
    side effects, so this primitive owns the bookkeeping explicitly.

    Atomicity: destination capacity is secured FIRST (``reserve_blocks``,
    all-or-nothing); only after the staged copy lands is the source table
    decref'd — on reservation failure the source is untouched and
    ``OutOfBlocks`` propagates. Refcounts: each source entry loses exactly
    the sequence's OWN reference, so blocks shared with a radix prefix
    tree or a COW fork survive on the source, still owned there; every
    destination block is freshly allocated with refcount 1 — the migrated
    copy is sequence-private (it is NOT inserted into any prefix cache).
    The pad block is never migrated: tables never contain it (asserted).

    Pass ``dst_table`` to supply pre-reserved destination blocks (the
    engine path reserves under backpressure before staging). The caller
    must serialize access to each pool against its owner's step loop.
    The source is only read. Its blocks are decref'd once the gather is
    queued: on one stream any later write into a reused source block
    runs after the gather has read it."""
    table = list(table)
    assert PAD_BLOCK not in table, "pad block in a sequence block table"
    if not table:
        return [], dst_pool
    if dst_table is None:
        dst_table = reserve_blocks(dst_alloc, len(table))
    else:
        dst_table = list(dst_table)
        assert len(dst_table) == len(table)
    stage = gather_pool_blocks(src_pool, table)
    scatter_pool_blocks(dst_pool, stage, dst_table)
    for b in table:
        src_alloc.decref(b)
    return dst_table, dst_pool


# ---------------------------------------------------------------------------
# Occupancy accounting (engine-pool load routing)

def bytes_per_token(cfg: ModelConfig, chunk: int = 256) -> int:
    """Marginal KV bytes per resident token, amortized over a reference
    window (sliding-window / recurrent layers make the true cost
    sub-linear; a 1k-token reference captures the steady state)."""
    ref = 1024
    return max(1, cache_bytes(cfg, 1, ref, chunk) // ref)


class OccupancyMeter:
    """Per-replica ledger of resident sequence tokens and decode slots.

    Engines advance the token ledger on prefill/decode and clear entries
    on release; the pool router reads ``tokens()`` as the KV-occupancy
    component of a replica's load. Under run-to-completion decode the
    ledger advances once per batch (``advance(sid, max_new)`` up front);
    under continuous batching it advances PER ITERATION (one token per
    resident sequence per step), so occupancy tracks what is actually
    written to the KV cache.

    ``decode_slots`` adds ADMITTED-slot introspection for the continuous
    decode loop: the loop acquires a slot at admission and releases it at
    eviction, so ``slots_used()`` reports which sequences are actively
    stepping. Note the pool's slot-aware decode router consults the
    loop's own ``decode_slots_free()`` (which also counts sequences
    WAITING for a slot), not this meter.

    When bound to a ``BlockAllocator`` (paged engines), ``tokens()`` and
    ``bytes()`` report ALLOCATED BLOCKS — the true memory footprint,
    counting a shared prefix once and quantizing at block granularity —
    instead of the per-sid amortized token ledger. The per-sid ledger is
    still maintained for ``seqs()`` and slot introspection."""

    def __init__(self, bytes_per_tok: int = 0, decode_slots: int = 0, *,
                 allocator: "BlockAllocator" = None, block_size: int = 0,
                 block_bytes: int = 0):
        self.bytes_per_tok = bytes_per_tok
        self.decode_slots = decode_slots
        self.allocator = allocator
        self.block_size = block_size
        self.block_bytes = block_bytes
        self._tokens: Dict[str, int] = {}
        self._slot_sids: set = set()
        self._lock = threading.Lock()

    def advance(self, sid: str, n: int):
        with self._lock:
            self._tokens[sid] = self._tokens.get(sid, 0) + int(n)

    def release(self, sid: str):
        with self._lock:
            self._tokens.pop(sid, None)

    def tokens(self) -> int:
        if self.allocator is not None:
            return self.allocator.used_blocks() * self.block_size
        with self._lock:
            return sum(self._tokens.values())

    def bytes(self) -> int:
        if self.allocator is not None:
            return self.allocator.used_blocks() * self.block_bytes
        return self.tokens() * self.bytes_per_tok

    def blocks(self) -> int:
        """Allocated pool blocks (0 when not block-bound)."""
        return 0 if self.allocator is None else self.allocator.used_blocks()

    def seqs(self) -> int:
        with self._lock:
            return len(self._tokens)

    # -- decode-slot accounting (continuous batching) ----------------------
    def acquire_slot(self, sid: str):
        with self._lock:
            self._slot_sids.add(sid)

    def release_slot(self, sid: str):
        with self._lock:
            self._slot_sids.discard(sid)

    def slots_used(self) -> int:
        with self._lock:
            return len(self._slot_sids)

    def slots_free(self) -> int:
        with self._lock:
            return max(0, self.decode_slots - len(self._slot_sids))


# ---------------------------------------------------------------------------
# Position bookkeeping (linear and ring-buffer caches)

def batch_pos(pos, batch: int, device=None):
    """Normalize pos (python int / scalar / (B,) vector) to (B,) int32 —
    per-sequence positions enable continuous batching in the engines."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return torch.broadcast_to(pos, (batch,))


def _slice_targets(pos, B, S, first, T, total, ring):
    """The chunk tokens that land in a rank's slice [first, first+T) of a
    cache of ``total`` slots: (rows, local slots, chunk indices), index
    tensors computed on the host (from host positions: a tensor ``pos`` is
    read back once), so that meta tensors take them too. Linear: the
    chunk's global start is clamped to [0, total - S] first, as the
    reference's ``dynamic_update_slice`` clamps it on the whole cache;
    ring: positions land at (pos + i) % total."""
    p = batch_pos(pos, B, "cpu").long()
    i = torch.arange(S)[None, :]
    if ring:
        g = (p[:, None] + i) % total
    else:
        g = torch.clamp(p, 0, total - S)[:, None] + i
    local = g - first
    keep = (local >= 0) & (local < T)
    rows = torch.arange(B)[:, None].expand(B, S)
    return rows[keep], local[keep], i.expand(B, S)[keep]


def _write_slice(buf, chunk, pos, seq, ring):
    first, total = seq
    rows, slots, src = _slice_targets(pos, buf.shape[0], chunk.shape[1],
                                      first, buf.shape[1], total, ring)
    if rows.numel():
        dev = buf.device
        buf[rows.to(dev), slots.to(dev)] = \
            chunk[rows.to(dev), src.to(dev)].to(buf.dtype)
    return buf


def write_linear(buf, chunk, pos, seq=None):
    """buf (B,T,...), chunk (B,S,...): write row b at [pos_b, pos_b+S),
    in place. Like ``jax.lax.dynamic_update_slice`` in the reference, the
    start is clamped to [0, T-S], so a chunk that would run past the end
    lands at T-S instead. With ``seq = (first, total)`` buf is a rank's
    slice of a sequence-split cache, global slots [first, first+T) of
    ``total``: the start is clamped on the global cache, then only the
    tokens whose slots fall in the slice are written."""
    if seq is not None:
        return _write_slice(buf, chunk, pos, seq, ring=False)
    B, T = buf.shape[0], buf.shape[1]
    S = chunk.shape[1]
    pos = batch_pos(pos, B, buf.device).long()
    start = torch.clamp(pos, 0, T - S)
    idx = start[:, None] + torch.arange(S, device=buf.device)[None, :]
    rows = torch.arange(B, device=buf.device)[:, None]
    buf[rows, idx] = chunk.to(buf.dtype)
    return buf


def write_ring(buf, chunk, pos, seq=None):
    """Ring-buffer write, in place: absolute positions pos_b..pos_b+S-1
    land at (pos_b+i) % W. Used by sliding-window layers. With ``seq =
    (first, total)``: a rank's slice of a ring of ``total`` slots (as
    ``write_linear``)."""
    if seq is not None:
        return _write_slice(buf, chunk, pos, seq, ring=True)
    B, W = buf.shape[0], buf.shape[1]
    S = chunk.shape[1]
    pos = batch_pos(pos, B, buf.device).long()
    idx = (pos[:, None] + torch.arange(S, device=buf.device)[None, :]) % W
    rows = torch.arange(B, device=buf.device)[:, None]
    buf[rows, idx] = chunk.to(buf.dtype)
    return buf


def slot_positions_linear(T, length):
    """Absolute position held by each slot of a linear cache of size T given
    per-seq total length (B,); -1 for unwritten slots. Returns (B,T)."""
    slot = torch.arange(T, device=length.device)[None, :]
    return torch.where(slot < length[:, None], slot, -1)


def slot_positions_ring(W, length):
    """Absolute position held by each ring slot; -1 if unwritten.
    Slot i holds the largest p < length_b with p % W == i. Returns (B,W)."""
    i = torch.arange(W, device=length.device)[None, :]
    L = length[:, None].long()
    p = (L - 1) - torch.remainder(L - 1 - i, W)
    return torch.where((p >= 0) & (L > 0), p, -1)
