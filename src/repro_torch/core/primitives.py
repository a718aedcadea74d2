"""Task primitives — the basic unit of Teola's fine-grained orchestration
(paper §4.1, Table 2).

Each primitive is a symbolic node with a metadata profile: its op, target
engine, the data keys it consumes/produces, originating component, and
scheduling attributes (topological depth, associated request count).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Set

# Primitive ops (Table 2). White = common engine ops, blue = decomposed
# LLM ops, gray = control flow.
EMBEDDING = "Embedding"
INGESTION = "Ingestion"
SEARCHING = "Searching"
RERANKING = "Reranking"
CHUNKING = "Chunking"
SEARCH_API = "SearchAPI"
PREFILL = "Prefilling"
DECODE = "Decoding"
PARTIAL_PREFILL = "PartialPrefilling"
FULL_PREFILL = "FullPrefilling"
PARTIAL_DECODE = "PartialDecoding"
CONDITION = "Condition"
AGGREGATE = "Aggregate"

LLM_OPS = {PREFILL, DECODE, PARTIAL_PREFILL, FULL_PREFILL, PARTIAL_DECODE}
CONTROL_OPS = {CONDITION, AGGREGATE}

_counter = itertools.count()


@dataclass
class Primitive:
    op: str
    engine: str
    component: str
    query_id: str = ""
    pid: str = ""
    # dataflow metadata: keys read from / written to the query object store
    consumes: Set[str] = field(default_factory=set)
    produces: Set[str] = field(default_factory=set)
    # op-specific metadata (prompt parts, batch items, seq/state ids, ...)
    config: Dict[str, Any] = field(default_factory=dict)
    # graph links (pids)
    parents: Set[str] = field(default_factory=set)
    children: Set[str] = field(default_factory=set)
    # annotations inherited from the component
    batchable: bool = False
    splittable: bool = False
    # scheduling metadata
    depth: int = 0
    num_requests: int = 1
    # explicit ordering edges that must survive Pass 1 (e.g.
    # Ingestion -> Searching consistency barrier)
    barrier: bool = False

    def __post_init__(self):
        if not self.pid:
            self.pid = f"{self.op}_{next(_counter)}"

    def __repr__(self):
        return (f"<{self.pid} eng={self.engine} comp={self.component} "
                f"depth={self.depth}>")


@dataclass
class Graph:
    """A primitive-level dataflow graph (p-graph or e-graph)."""
    nodes: Dict[str, Primitive] = field(default_factory=dict)
    query_id: str = ""

    def add(self, prim: Primitive) -> Primitive:
        prim.query_id = self.query_id
        self.nodes[prim.pid] = prim
        return prim

    def edge(self, a: Primitive, b: Primitive):
        a.children.add(b.pid)
        b.parents.add(a.pid)

    def unedge(self, a: Primitive, b: Primitive):
        a.children.discard(b.pid)
        b.parents.discard(a.pid)

    def remove(self, prim: Primitive):
        for p in list(prim.parents):
            self.nodes[p].children.discard(prim.pid)
        for c in list(prim.children):
            self.nodes[c].parents.discard(prim.pid)
        del self.nodes[prim.pid]

    def roots(self) -> List[Primitive]:
        return [n for n in self.nodes.values() if not n.parents]

    def topo_order(self) -> List[Primitive]:
        indeg = {p: len(n.parents) for p, n in self.nodes.items()}
        ready = [p for p, d in indeg.items() if d == 0]
        out = []
        while ready:
            pid = ready.pop()
            out.append(self.nodes[pid])
            for c in self.nodes[pid].children:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(out) != len(self.nodes):
            raise ValueError("cycle in primitive graph")
        return out

    def assign_depths(self):
        """Reverse-topological depth (Algorithm 2, Event 1): output nodes
        have depth 0; a parent's depth is max(child)+1."""
        order = self.topo_order()
        for n in self.nodes.values():
            n.depth = 0
        for n in reversed(order):
            for ppid in n.parents:
                p = self.nodes[ppid]
                p.depth = max(p.depth, n.depth + 1)

    def validate(self):
        for pid, n in self.nodes.items():
            assert n.pid == pid
            for c in n.children:
                assert pid in self.nodes[c].parents, (pid, c)
            for p in n.parents:
                assert pid in self.nodes[p].children, (pid, p)
        self.topo_order()  # raises on cycles
        return True
