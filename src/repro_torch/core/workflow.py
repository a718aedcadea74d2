"""Developer-facing workflow template API (paper §3.2, Listing 1).

Developers register execution engines, declare components (`Node`) with
engines/roles/IO and optimization annotations, and chain them with `>>`.
The template is coarse-grained — per-query decomposition into primitives
happens in pgraph.GraphTransform.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class EngineSpec:
    """Registered execution engine + latency/batching profile."""
    name: str
    kind: str                      # 'llm' | 'embedding' | 'rerank' |
    #                                'vectordb' | 'chunker' | 'search_api'
    max_batch: int = 8             # max efficient batch (profiled)
    max_tokens: int = 1024         # LLM: max efficient batched token count
    instances: int = 1             # pool size (EnginePool replicas)
    resource: Dict[str, int] = field(default_factory=dict)
    config: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_engine(cls, name: str, eng) -> "EngineSpec":
        """Pool-aware registration: `eng` may be a bare engine, a list of
        replicas, or an EnginePool; the profile comes from the primary
        replica and `instances` reflects the pool size."""
        from repro_torch.core.engine_pool import pool_size, primary_of
        inst = primary_of(eng)
        return cls(name=name, kind=getattr(inst, "kind", "misc"),
                   max_batch=getattr(inst, "max_batch", 8),
                   max_tokens=getattr(inst, "max_tokens", 1024),
                   instances=pool_size(eng))


class Node:
    """A workflow template component.

    config may carry a ``degrade`` annotation — the component's graceful-
    degradation contract, activated stepwise by the overload layer's
    brown-out ladder (serving/overload.py) and ignored otherwise:
      ``{"min_top_k": k}``   retrieval/rerank top_k may shrink to k (L1)
      ``{"skippable": True}`` the component may be skipped outright (L2,
                             rerank: unscored candidate passthrough)
      ``{"min_new": m}``      generation max_new may halve down to m (L3)
      ``{"chunk_cap": c}``    chunked prefill capped to c tokens/pass (L3)
    """

    def __init__(self, kind: str, engine: str, name: Optional[str] = None,
                 anno: Optional[str] = None, config: Optional[dict] = None):
        self.kind = kind
        self.engine = engine
        self.name = name or kind
        self.anno = anno or ""            # 'batchable' | 'splittable' | ''
        self.config = dict(config or {})
        self.downstream: List["Node"] = []

    def __rshift__(self, other: "Node") -> "Node":
        self.downstream.append(other)
        return other

    def __repr__(self):
        return f"Node({self.name}:{self.kind}@{self.engine})"


class APP:
    """An application: engines + workflow template."""

    def __init__(self, name: str):
        self.name = name
        self.engines: Dict[str, EngineSpec] = {}
        self.template: List[Node] = []

    @classmethod
    def init(cls, name: str = "app") -> "APP":
        return cls(name)

    def register_engine(self, spec: EngineSpec):
        self.engines[spec.name] = spec
        return spec

    def update_template(self, nodes: List[Node]):
        self.template = list(nodes)
        for n in nodes:
            if n.engine not in self.engines:
                raise ValueError(f"{n}: engine {n.engine!r} not registered")
        return self

    def template_edges(self):
        edges = []
        for n in self.template:
            for d in n.downstream:
                edges.append((n, d))
        return edges
