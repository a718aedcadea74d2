"""Graph optimization passes (paper §4.2, Algorithm 1's GraphOpt).

Pass 1  Dependency pruning      — rebuild edges from data dependencies only
Pass 2  Stage decomposition     — split oversized batchable primitives into
                                  pipelined micro-stages (+ Aggregate)
Pass 3  LLM prefilling split    — Partial/Full Prefilling for prompt parts
                                  available before retrieval completes
Pass 4  LLM decoding pipelining — splittable decodes become chained
                                  Partial Decodings feeding per-item clones
                                  of downstream batchable primitives

The optimizer applies passes to a p-graph to produce the e-graph; each
pass is a standalone, individually-testable transformation.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional

from repro_torch.core import primitives as P
from repro_torch.core.primitives import Graph, Primitive

_uid = itertools.count()


# ---------------------------------------------------------------------------
# Pass 1

def pass1_prune_dependencies(g: Graph) -> Graph:
    """Remaining edges represent data dependencies ONLY: an edge (a, b)
    survives iff b consumes a key a produces. Template-order edges that
    carry no data are pruned, detaching independent branches (e.g. the
    indexing pipeline from query expansion)."""
    producers: Dict[str, str] = {}
    for n in g.nodes.values():
        for k in n.produces:
            producers[k] = n.pid
    for n in list(g.nodes.values()):
        for cpid in list(n.children):
            c = g.nodes[cpid]
            if not (n.produces & c.consumes):
                g.unedge(n, c)
    # add any missing data edges (consumer of k -> producer of k)
    for n in g.nodes.values():
        for k in n.consumes:
            ppid = producers.get(k)
            if ppid is not None and ppid != n.pid:
                g.edge(g.nodes[ppid], n)
    return g


# ---------------------------------------------------------------------------
# Pass 2

def pass2_stage_decompose(g: Graph, engines) -> Graph:
    """Batchable primitives whose request count exceeds the engine's
    max-efficient batch are split into pipelined stages. A directly-chained
    batchable consumer with the same item count is split stage-wise too
    (embedding -> ingestion; contextualize prefill -> decode); an Aggregate
    primitive re-joins the final keys."""
    for n in list(g.nodes.values()):
        if not (n.batchable and "items_key" in n.config):
            continue
        if n.pid not in g.nodes:        # already replaced as a chained pair
            continue
        eng = engines.get(n.engine)
        maxb = getattr(eng, "max_batch", 8) if eng else 8
        if n.num_requests <= maxb:
            continue
        _split_stages(g, n, maxb, engines)
    return g


def _chained_partner(g: Graph, n: Primitive) -> Optional[Primitive]:
    if len(n.children) != 1:
        return None
    c = g.nodes[next(iter(n.children))]
    if (c.batchable and c.num_requests == n.num_requests
            and len(c.parents) == 1 and "items_key" in c.config):
        return c
    return None


def _split_stages(g: Graph, n: Primitive, maxb: int, engines):
    stages = math.ceil(n.num_requests / maxb)
    partner = _chained_partner(g, n)
    chain = [n] if partner is None else [n, partner]

    made = {}  # (prim, stage) -> clone
    for prim in chain:
        pkey = next(iter(prim.produces))
        clones = []
        for s in range(stages):
            lo, hi = s * maxb, min((s + 1) * maxb, prim.num_requests)
            c = Primitive(
                op=prim.op, engine=prim.engine, component=prim.component,
                consumes=set(prim.consumes), produces={f"{pkey}#s{s}"},
                batchable=True, num_requests=hi - lo,
                splittable=prim.splittable,
                config={**prim.config, "item_range": (lo, hi),
                        "stage": s, "stage_of": prim.pid})
            g.add(c)
            clones.append(c)
            made[(prim.pid, s)] = c
        made[prim.pid] = clones

    # wire: stage s of chain[i] -> stage s of chain[i+1]
    for i in range(len(chain) - 1):
        up_key = next(iter(chain[i].produces))
        for s in range(stages):
            a, b = made[(chain[i].pid, s)], made[(chain[i + 1].pid, s)]
            b.consumes = (b.consumes - {up_key}) | {f"{up_key}#s{s}"}
            g.edge(a, b)

    # parents of the head feed all head stages
    for ppid in list(chain[0].parents):
        for s in range(stages):
            g.edge(g.nodes[ppid], made[(chain[0].pid, s)])

    # Aggregate joins the tail stages and emits the original key(s)
    tail = chain[-1]
    agg = g.add(Primitive(
        op=P.AGGREGATE, engine="control", component=tail.component,
        consumes={f"{next(iter(tail.produces))}#s{s}" for s in range(stages)},
        produces=set(tail.produces),
        config={"concat_of": next(iter(tail.produces))}))
    for s in range(stages):
        g.edge(made[(tail.pid, s)], agg)
    for cpid in list(tail.children):
        g.edge(agg, g.nodes[cpid])

    for prim in chain:
        g.remove(prim)


# ---------------------------------------------------------------------------
# Pass 3

def pass3_prefill_split(g: Graph) -> Graph:
    """Causal prefilling: prompt parts available at query arrival
    (instruction / question / earlier drafts already produced) can be
    prefilled before late parts (retrieved context). Split Prefilling into
    PartialPrefilling (early parts) + FullPrefilling (late parts)."""
    producers = {k: n.pid for n in g.nodes.values() for k in n.produces}
    for n in list(g.nodes.values()):
        if n.op != P.PREFILL or n.config.get("per_item_seq"):
            continue
        parts = n.config.get("parts") or []
        early = [p for p in parts if p[1] is None
                 or producers.get(p[1]) is None]
        late = [p for p in parts if not (p[1] is None
                                         or producers.get(p[1]) is None)]
        # keep prompt order causal: early parts must be a prefix
        n_early = 0
        for name, key in parts:
            if key is None or producers.get(key) is None:
                n_early += 1
            else:
                break
        early = parts[:n_early]
        late = parts[n_early:]
        if not early or not late:
            continue
        sid = n.config["sid"]
        pp = g.add(Primitive(
            op=P.PARTIAL_PREFILL, engine=n.engine, component=n.component,
            consumes={k for _, k in early if k is not None},
            produces={f"state:{sid}:0p"},
            config={**n.config, "parts": early, "partial": True}))
        fp = g.add(Primitive(
            op=P.FULL_PREFILL, engine=n.engine, component=n.component,
            consumes=({k for _, k in late if k is not None}
                      | {f"state:{sid}:0p"}),
            produces=set(n.produces),
            config={**n.config, "parts": late, "continue_partial": True}))
        g.edge(pp, fp)
        for ppid in list(n.parents):
            parent = g.nodes[ppid]
            if parent.produces & pp.consumes:
                g.edge(parent, pp)
            if parent.produces & fp.consumes:
                g.edge(parent, fp)
        for cpid in list(n.children):
            g.edge(fp, g.nodes[cpid])
        g.remove(n)
    return g


# ---------------------------------------------------------------------------
# Pass 4

def pass4_decode_pipeline(g: Graph) -> Graph:
    """Splittable decodes stream semantically-complete items: Decoding is
    replaced by a chain of Partial Decodings (each continues the same
    sequence for one item's tokens) and downstream *itemizable* primitives
    are cloned per item, so item 0's embedding/search runs while item 1 is
    still decoding."""
    for n in list(g.nodes.values()):
        if n.op != P.DECODE or not n.splittable:
            continue
        k = int(n.config.get("num_items", 1))
        if k <= 1:
            continue
        out_key = n.config["out_key"]
        sid = n.config["sid"]
        v = n.config.get("state_v", 2)
        per_item_new = max(1, n.config.get("max_new", 24) // k)

        pds = []
        prev = None
        for i in range(k):
            pd = Primitive(
                op=P.PARTIAL_DECODE, engine=n.engine, component=n.component,
                consumes=(set(n.consumes) if i == 0
                          else {f"state:{sid}:{v}p{i - 1}"}),
                produces={f"{out_key}#{i}", f"state:{sid}:{v}p{i}"},
                config={**n.config, "item": i, "max_new": per_item_new,
                        "out_key": f"{out_key}#{i}"})
            g.add(pd)
            if prev is not None:
                g.edge(prev, pd)
            pds.append(pd)
            prev = pd
        # the final PD also publishes the aggregate key for non-itemizable
        # consumers
        pds[-1].produces.add(out_key)
        pds[-1].config["also_aggregate"] = out_key

        for ppid in list(n.parents):
            parent = g.nodes[ppid]
            if parent.produces & pds[0].consumes:
                g.edge(parent, pds[0])
        # clone itemizable consumers per item
        for cpid in list(n.children):
            child = g.nodes[cpid]
            if child.config.get("itemizable") and out_key in child.consumes:
                _itemize_chain(g, child, out_key, pds, k)
            else:
                g.edge(pds[-1], child)
        g.remove(n)
    return g


def _itemize_chain(g: Graph, node: Primitive, key: str, producers, k: int):
    """Clone `node` (and recursively its itemizable single-consumer chain)
    per item i, rewiring item i's clone to producers[i]."""
    clones = []
    for i in range(k):
        cfg = {**node.config, "item": i}
        if cfg.get("items_key") == key:
            cfg["items_key"] = f"{key}#{i}"
        c = Primitive(
            op=node.op, engine=node.engine, component=node.component,
            consumes={(f"{key}#{i}" if x == key else x)
                      for x in node.consumes},
            produces={f"{x}#{i}" for x in node.produces},
            batchable=node.batchable, num_requests=1,
            config=cfg)
        g.add(c)
        g.edge(producers[i], c)
        # non-key parents (e.g. index_ready) feed every clone
        for ppid in node.parents:
            parent = g.nodes[ppid]
            if parent.produces & c.consumes:
                g.edge(parent, c)
        clones.append(c)

    for cpid in list(node.children):
        child = g.nodes[cpid]
        child_key = next(iter(node.produces & child.consumes), None)
        if child.config.get("itemizable") and child_key:
            _itemize_chain(g, child, child_key, clones, k)
        else:
            # non-itemizable consumer (e.g. rerank) reads all item keys
            if child_key:
                child.consumes.discard(child_key)
                child.consumes |= {f"{child_key}#{i}" for i in range(k)}
            for c in clones:
                g.edge(c, child)
    g.remove(node)


# ---------------------------------------------------------------------------

ALL_PASSES = ("prune", "stage", "prefill_split", "decode_pipeline")


def graph_opt(g: Graph, engines, passes=ALL_PASSES) -> Graph:
    """GraphOpt (Algorithm 1): apply optimization passes; the result is the
    e-graph handed to the runtime. Depths are assigned per Algorithm 2."""
    if "prune" in passes:
        pass1_prune_dependencies(g)
    if "stage" in passes:
        pass2_stage_decompose(g, engines)
    if "prefill_split" in passes:
        pass3_prefill_split(g)
    if "decode_pipeline" in passes:
        pass4_decode_pipeline(g)
    g.validate()
    g.assign_depths()
    return g
