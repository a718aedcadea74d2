"""p-Graph construction: GraphTransform (Algorithm 1).

Decomposes each template component, with query-specific configuration,
into symbolic primitives with explicit data dependencies, then links
components along the template edges (tail primitive -> head primitive).
Data keys are unique per producer; LLM sequence state is threaded through
versioned `state:{sid}:{v}` keys so Pass 1's dataflow-only edge rebuild
preserves prefill/decode ordering for free.
"""
from __future__ import annotations

import itertools
from typing import Dict

from repro_torch.core import primitives as P
from repro_torch.core.primitives import Graph, Primitive
from repro_torch.core.prompts import INSTRUCTIONS
from repro_torch.core.workflow import APP, Node

_sid = itertools.count()


def _llm_seq(g: Graph, comp: Node, *, parts, out_key, max_new, num_items=1,
             splittable=False, consumes_extra=(), instruction=None,
             degrade=None):
    """Prefill + Decode primitive pair for one LLM sequence.
    parts: ordered list of (part_name, data_key_or_None) — None means the
    part is static text available at query arrival (instruction etc.).
    ``degrade`` (optional dict) annotates both primitives with their
    graceful-degradation contract (overload layer: min_new, chunk_cap)."""
    sid = f"s{next(_sid)}"
    pf_consumes = {k for _, k in parts if k is not None}
    pf = g.add(Primitive(
        op=P.PREFILL, engine=comp.engine, component=comp.name,
        consumes=pf_consumes | set(consumes_extra),
        produces={f"state:{sid}:1"},
        config={"parts": list(parts), "sid": sid, "state_v": 1,
                "instruction": instruction}))
    dc = g.add(Primitive(
        op=P.DECODE, engine=comp.engine, component=comp.name,
        consumes={f"state:{sid}:1"},
        produces={out_key, f"state:{sid}:2"},
        splittable=splittable,
        config={"sid": sid, "state_v": 2, "out_key": out_key,
                "max_new": max_new, "num_items": num_items}))
    if degrade:
        pf.config["degrade"] = dict(degrade)
        dc.config["degrade"] = dict(degrade)
    g.edge(pf, dc)
    return pf, dc


def decompose_component(g: Graph, comp: Node, C: dict,
                        produced_by: Dict[str, str]):
    """Appends this component's primitives to g; returns (head, tail)."""
    kind = comp.kind
    cc = {**comp.config, **C.get(comp.name, {})}

    if kind == "chunk":
        n = g.add(Primitive(
            op=P.CHUNKING, engine=comp.engine, component=comp.name,
            consumes={"docs"}, produces={"chunks"},
            config={"chunk_size": cc.get("chunk_size", 48),
                    "overlap": cc.get("overlap", 8)}))
        return n, n

    if kind == "index":
        nreq = cc.get("num_chunks", 32)
        emb = g.add(Primitive(
            op=P.EMBEDDING, engine=comp.engine, component=comp.name,
            consumes={cc.get("in_key", "chunks")}, produces={"chunk_vecs"},
            batchable=True, num_requests=nreq,
            config={"items_key": cc.get("in_key", "chunks")}))
        ing = g.add(Primitive(
            op=P.INGESTION, engine=cc.get("db_engine", "vectordb"),
            component=comp.name, consumes={"chunk_vecs"},
            produces={"index_ready"}, batchable=True, num_requests=nreq,
            config={"items_key": "chunk_vecs"}))
        g.edge(emb, ing)
        return emb, ing

    if kind == "query_embed":
        in_key = cc.get("in_key", "question")
        n = g.add(Primitive(
            op=P.EMBEDDING, engine=comp.engine, component=comp.name,
            consumes={in_key}, produces={"query_vecs"},
            batchable=True, num_requests=cc.get("num_queries", 1),
            config={"items_key": in_key, "itemizable": True}))
        return n, n

    if kind == "vector_search":
        n = g.add(Primitive(
            op=P.SEARCHING, engine=comp.engine, component=comp.name,
            consumes={"query_vecs", "index_ready"}, produces={"retrieved"},
            batchable=True, num_requests=cc.get("num_queries", 1),
            config={"top_k": cc.get("top_k", 3), "items_key": "query_vecs",
                    "itemizable": True}))
        if cc.get("degrade"):
            n.config["degrade"] = dict(cc["degrade"])
        return n, n

    if kind == "rerank":
        n = g.add(Primitive(
            op=P.RERANKING, engine=comp.engine, component=comp.name,
            consumes={"retrieved", "question"}, produces={"top_chunks"},
            batchable=True, num_requests=cc.get("num_candidates", 16),
            config={"top_k": cc.get("top_k", 3)}))
        if cc.get("degrade"):
            n.config["degrade"] = dict(cc["degrade"])
        return n, n

    if kind == "llm_expand":
        k = cc.get("num_expanded", 3)
        pf, dc = _llm_seq(
            g, comp,
            parts=[("instruction", None), ("question", "question")],
            out_key="expanded_queries", max_new=cc.get("max_new", 24),
            num_items=k, splittable=(comp.anno == "splittable"),
            instruction=cc.get("instruction", INSTRUCTIONS["expand"]),
            degrade=cc.get("degrade"))
        return pf, dc

    if kind == "llm_judge":
        pf, dc = _llm_seq(
            g, comp,
            parts=[("instruction", None), ("question", "question")],
            out_key="judge_out", max_new=cc.get("max_new", 8),
            instruction=cc.get("instruction", INSTRUCTIONS["judge"]))
        cond = g.add(Primitive(
            op=P.CONDITION, engine="control", component=comp.name,
            consumes={"judge_out"}, produces={"need_search"},
            config={"predicate": cc.get("predicate", "always_true")}))
        g.edge(dc, cond)
        return pf, cond

    if kind == "search_api":
        n = g.add(Primitive(
            op=P.SEARCH_API, engine=comp.engine, component=comp.name,
            consumes={"question", "need_search"}, produces={"web_results"},
            config={"top_k": cc.get("top_k", 4)}))
        return n, n

    if kind == "contextualize":
        nreq = cc.get("num_chunks", 32)
        sid = f"ctx{next(_sid)}"
        pf = g.add(Primitive(
            op=P.PREFILL, engine=comp.engine, component=comp.name,
            consumes={"chunks"}, produces={"ctx_state"},
            batchable=True, num_requests=nreq,
            config={"parts": [("instruction", None), ("chunk", "chunks")],
                    "items_key": "chunks", "per_item_seq": True, "sid": sid,
                    "instruction": cc.get("instruction",
                                          INSTRUCTIONS["contextualize"])}))
        dc = g.add(Primitive(
            op=P.DECODE, engine=comp.engine, component=comp.name,
            consumes={"ctx_state"}, produces={"ctx_chunks"},
            batchable=True, num_requests=nreq,
            config={"out_key": "ctx_chunks", "per_item_seq": True,
                    "sid": sid, "max_new": cc.get("max_new", 12),
                    "items_key": "ctx_state"}))
        g.edge(pf, dc)
        return pf, dc

    if kind == "llm_generate":
        mode = cc.get("mode", "oneshot")
        ctx_key = cc.get("context_key", "top_chunks")
        k = cc.get("num_context", 3)
        if mode == "oneshot":
            pf, dc = _llm_seq(
                g, comp,
                parts=[("instruction", None), ("question", "question"),
                       ("context", ctx_key)],
                out_key="answer", max_new=cc.get("max_new", 32),
                instruction=cc.get("instruction", INSTRUCTIONS["oneshot"]),
                degrade=cc.get("degrade"))
            return pf, dc
        if mode == "refine":
            head = None
            prev_dc = None
            for i in range(k):
                parts = [("instruction", None),
                         ("question", "question"),
                         ("context", f"{ctx_key}#{i}" if k > 1 else ctx_key)]
                if prev_dc is not None:
                    parts.insert(2, ("draft", f"answer@{i - 1}"))
                pf, dc = _llm_seq(
                    g, comp, parts=parts,
                    out_key="answer" if i == k - 1 else f"answer@{i}",
                    max_new=cc.get("max_new", 32),
                    instruction=cc.get("instruction", INSTRUCTIONS["refine"]),
                    degrade=cc.get("degrade"))
                if head is None:
                    head = pf
                if prev_dc is not None:
                    g.edge(prev_dc, pf)
                prev_dc = dc
            return head, prev_dc
        if mode == "tree":
            # k parallel leaf calls + aggregating final call
            leaves = []
            for i in range(k):
                pf, dc = _llm_seq(
                    g, comp,
                    parts=[("instruction", None), ("question", "question"),
                           ("context", f"{ctx_key}#{i}" if k > 1 else
                            ctx_key)],
                    out_key=f"leaf_answer@{i}",
                    max_new=cc.get("max_new", 24),
                    instruction=cc.get("instruction", INSTRUCTIONS["tree"]),
                    degrade=cc.get("degrade"))
                leaves.append((pf, dc))
            agg = g.add(Primitive(
                op=P.AGGREGATE, engine="control", component=comp.name,
                consumes={f"leaf_answer@{i}" for i in range(k)},
                produces={"leaf_answers"}, config={}))
            for _, dc in leaves:
                g.edge(dc, agg)
            pf, dc = _llm_seq(
                g, comp,
                parts=[("instruction", None), ("question", "question"),
                       ("drafts", "leaf_answers")],
                out_key="answer", max_new=cc.get("max_new", 32),
                instruction=cc.get("instruction", INSTRUCTIONS["combine"]),
                degrade=cc.get("degrade"))
            g.edge(agg, pf)
            return leaves[0][0], dc
        raise ValueError(f"unknown llm_generate mode {mode}")

    raise ValueError(f"unknown component kind {kind!r}")


def graph_transform(app: APP, query: dict, C: dict | None = None) -> Graph:
    """Algorithm 1 GraphTransform: template + query config -> p-graph."""
    C = dict(C or {})
    # query-specific sizing: the chunk count drives batchable primitive
    # request counts (paper: p-graph reflects the query's input data)
    if "docs" in query:
        from repro_torch.engines.model_free import ChunkerEngine
        chunk_comps = [c for c in app.template if c.kind == "chunk"]
        cs = chunk_comps[0].config.get("chunk_size", 48) if chunk_comps \
            else 48
        ov = chunk_comps[0].config.get("overlap", 8) if chunk_comps else 8
        n_chunks = ChunkerEngine.count_chunks(query["docs"], cs, ov)
        for comp in app.template:
            if comp.kind in ("index", "contextualize"):
                C.setdefault(comp.name, {}).setdefault("num_chunks",
                                                       max(1, n_chunks))
    g = Graph(query_id=query.get("id", "q0"))
    # split context keys for multi-context synthesis: rerank publishes
    # top_chunks#i per context slot when the generator consumes them
    bounds: Dict[Node, tuple] = {}
    for comp in app.template:
        head, tail = decompose_component(g, comp, C, {})
        bounds[comp] = (head, tail)
    for a, b in app.template_edges():
        g.edge(bounds[a][1], bounds[b][0])
    # rerank -> refine/tree: expose per-slot context keys
    _split_context_keys(g)
    g.validate()
    return g


def _split_context_keys(g: Graph):
    """If a consumer reads a per-slot key 'base#i' of a key 'base' that a
    single node produces (e.g. tree/refine synthesis reading
    top_chunks#i / retrieved#i), that producer advertises the slot keys
    too — it writes them all at completion."""
    producers = {}
    for n in g.nodes.values():
        for k in n.produces:
            producers[k] = n
    for n in g.nodes.values():
        for k in n.consumes:
            if "#" in k and k not in producers:
                base = k.split("#")[0]
                if base in producers:
                    producers[base].produces.add(k)
                    producers[base].config.setdefault("slot_keys",
                                                      []).append(k)
