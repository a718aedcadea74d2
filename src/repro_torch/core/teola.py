"""Teola facade: parse query -> p-graph -> optimize -> e-graph -> schedule.

Also hosts the baseline orchestrators used in the paper's evaluation:
  - LlamaDist      module-chain execution (coarse orchestration)
  - LlamaDistPC    + manual module parallelization + instruction KV reuse
  - AutoGenLike    agent-grouped sequential execution
All baselines share the same engines and runtime; only orchestration
granularity (and the engine scheduling policy) differs.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.engine_pool import replicas_of
from repro_torch.core.passes import ALL_PASSES, graph_opt
from repro_torch.core.pgraph import graph_transform
from repro_torch.core.primitives import Graph
from repro_torch.core.runtime import QueryContext, Runtime
from repro_torch.core.workflow import APP


class Teola:
    def __init__(self, app: APP, engines: Dict, *, policy: str = "topo",
                 passes=ALL_PASSES, streaming: bool = False,
                 continuous_batching: bool = False,
                 fault_tolerance=None, overload=None):
        self.app = app
        self.engines = engines
        self.passes = passes
        self.runtime = Runtime(engines, policy=policy, streaming=streaming,
                               continuous_batching=continuous_batching,
                               fault_tolerance=fault_tolerance,
                               overload=overload)
        self._egraph_cache: Dict[str, Graph] = {}

    def _cache_key(self, query: dict):
        """e-graph structure depends only on the query's SIZE parameters
        (paper §4.2: cache and reuse optimized subgraphs)."""
        if "docs" not in query:
            return (self.app.name, 0)
        from repro_torch.engines.model_free import ChunkerEngine
        chunk = next((n for n in self.app.template if n.kind == "chunk"),
                     None)
        cs = chunk.config.get("chunk_size", 48) if chunk else 48
        ov = chunk.config.get("overlap", 8) if chunk else 8
        return (self.app.name,
                ChunkerEngine.count_chunks(query["docs"], cs, ov))

    def build_egraph(self, query: dict, C: Optional[dict] = None,
                     use_cache: bool = True) -> Graph:
        key = self._cache_key(query) if (use_cache and C is None) else None
        if key is not None and key in self._egraph_cache:
            return self._egraph_cache[key]
        g = graph_transform(self.app, query, C)
        g = graph_opt(g, self.app.engines, self.passes)
        if key is not None:
            self._egraph_cache[key] = g
        return g

    def submit(self, query: dict, C: Optional[dict] = None,
               priority: int = 0, slo: Optional[str] = None,
               tenant: str = "default") -> QueryContext:
        g = self.build_egraph(query, C)
        inputs = {k: v for k, v in query.items() if k != "id"}
        return self.runtime.submit(g, inputs, priority=priority,
                                   slo=slo, tenant=tenant)

    def query(self, query: dict, C: Optional[dict] = None, timeout=120,
              priority: int = 0, slo: Optional[str] = None,
              tenant: str = "default"):
        ctx = self.submit(query, C, priority=priority, slo=slo,
                          tenant=tenant)
        out = ctx.result(timeout)
        return out, ctx

    def shutdown(self):
        self.runtime.shutdown()


# ---------------------------------------------------------------------------
# Baselines

class _ModuleChain:
    """Shared machinery: execute the workflow one component-group at a
    time; each group is the unoptimized primitive sub-graph of its
    components (no cross-group overlap — the module boundary is a
    barrier)."""
    PASSES = ()                     # no graph optimization

    def __init__(self, app: APP, engines: Dict, *, policy: str = "to"):
        self.app = app
        self.engines = engines
        self.runtime = Runtime(engines, policy=policy)

    def groups(self) -> List[List[str]]:
        # one group per component (LlamaDist)
        return [[n.name] for n in self.app.template]

    def parallel_groups(self) -> List[List[List[str]]]:
        """Phases of groups that may run concurrently (LlamaDistPC)."""
        return [[g] for g in self.groups()]

    def _build(self, query):
        g = graph_transform(self.app, query, None)
        # keep template edges (module barrier); only assign depths
        g.assign_depths()
        return g

    def submit(self, query: dict, C=None) -> QueryContext:
        g = self._build(query)
        inputs = {k: v for k, v in query.items() if k != "id"}
        ctx = QueryContext(g, inputs)
        ctx.indegree = {pid: len(n.parents) for pid, n in g.nodes.items()}
        # the runtime's shutdown joins this thread (it releases the
        # query's sequences after marking it done)
        self.runtime.aux.start(self._run, (g, ctx), name=f"chain:{ctx.qid}")
        return ctx

    def _run(self, g: Graph, ctx: QueryContext):
        try:
            produced = set()
            for n in g.nodes.values():
                produced |= set(n.produces)
            for phase in self.parallel_groups():
                threads = []
                for group in phase:
                    th = threading.Thread(
                        target=self._run_group,
                        args=(g, ctx, group, produced))
                    th.start()
                    threads.append(th)
                for th in threads:
                    th.join()
            ctx.t_done = time.time()
        except Exception as e:  # noqa: BLE001
            ctx.error = e
        finally:
            ctx.done.set()
            for eng in self.engines.values():
                for inst in replicas_of(eng):
                    if hasattr(inst, "release"):
                        for sid in ctx.sids:
                            inst.release(sid)
                    if hasattr(inst, "drop"):
                        inst.drop(ctx.qid)

    def _run_group(self, g: Graph, ctx: QueryContext, group: List[str],
                   produced=frozenset()):
        """Run the primitives of these components, respecting intra-group
        dependencies, blocking until all complete. A failure is recorded
        on the context (thread exceptions would otherwise vanish and a
        sibling group waiting on this group's outputs would spin)."""
        nodes = [n for n in g.topo_order() if n.component in group]
        try:
            for n in nodes:
                self._exec_node(n, ctx, produced)
        except Exception as e:  # noqa: BLE001
            if ctx.error is None:
                ctx.error = e

    def _exec_node(self, prim, ctx, produced=frozenset()):
        from repro_torch.core.executors import run_control
        from repro_torch.core.runtime import NodeTask
        # payloads are resolved lazily from the store on the engine
        # scheduler thread, so inputs produced by ANOTHER group running
        # in the same phase must be present before submission (the
        # managed path gets this ordering from in-degree tracking)
        deps = [k for k in prim.consumes if k in produced]
        while not all(k in ctx.store for k in deps):
            if ctx.error:
                raise ctx.error
            time.sleep(0.001)
        if prim.engine == "control":
            run_control(prim, ctx)
            return
        sched = self.runtime.scheds[prim.engine]
        ctx.node_spans.setdefault(prim.pid, (time.time(), None))
        sched.submit(NodeTask(prim, ctx, managed=False))
        # wait on per-task completion via polling the store keys
        while True:
            if ctx.error:
                raise ctx.error
            if all(k in ctx.store for k in prim.produces):
                return
            time.sleep(0.001)

    def query(self, query: dict, C=None, timeout=120):
        ctx = self.submit(query, C)
        out = ctx.result(timeout)
        return out, ctx

    def shutdown(self):
        self.runtime.shutdown()


class LlamaDist(_ModuleChain):
    """Ray-based distributed LlamaIndex stand-in: strict module chain."""


class LlamaDistPC(_ModuleChain):
    """LlamaDist + manual parallelization of independent modules +
    instruction-prefix KV cache reuse."""

    def __init__(self, app, engines, *, policy: str = "to"):
        super().__init__(app, engines, policy=policy)
        self._warm_prefix_cache()

    def _warm_prefix_cache(self):
        # pre-compute instruction KV prefixes on the LLM engines
        from repro_torch.core.prompts import INSTRUCTIONS
        defaults = {"llm_expand": INSTRUCTIONS["expand"],
                    "llm_judge": INSTRUCTIONS["judge"],
                    "contextualize": INSTRUCTIONS["contextualize"]}
        gen_defaults = {"oneshot": INSTRUCTIONS["oneshot"],
                        "refine": INSTRUCTIONS["refine"],
                        "tree": INSTRUCTIONS["tree"]}
        for n in self.app.template:
            instr = n.config.get("instruction") or defaults.get(n.kind) \
                or gen_defaults.get(n.config.get("mode", ""))
            eng = self.engines.get(n.engine)
            for inst in replicas_of(eng):
                if hasattr(inst, "get_prefix_state"):
                    inst.use_prefix_cache = True
                    if instr:
                        inst.get_prefix_state(instr)

    def parallel_groups(self):
        """Manually parallelize known-independent modules: the indexing
        pipeline runs concurrently with query expansion / judging."""
        names = [n.name for n in self.app.template]
        phases: List[List[List[str]]] = []
        done = set()

        def take(*keys):
            return [k for k in keys if k in names and k not in done]

        # phase 1: chunking (everything depends on chunks)
        p1 = take("chunk", "contextualize")
        if p1:
            phases.append([[x] for x in p1])
            done.update(p1)
        # phase 2: indexing ∥ (query expansion | judge)
        par = []
        for grp in (take("indexing"), take("query_expansion"),
                    take("proxy_judge"), take("query_embedding")
                    if "query_expansion" not in names else []):
            if grp:
                par.append(grp)
        if par:
            phases.append(par)
            done.update(x for g in par for x in g)
        # remaining components sequentially
        for n in names:
            if n not in done:
                phases.append([[n]])
                done.add(n)
        return phases


class AutoGenLike(_ModuleChain):
    """Agent-grouped orchestration: consecutive components sharing a broad
    role are fused into one agent; agents run sequentially."""

    ROLE_OF = {
        "chunk": "retrieval", "indexing": "retrieval",
        "query_embedding": "retrieval", "vector_search": "retrieval",
        "contextualize": "retrieval",
        "query_expansion": "expansion", "rerank": "rerank",
        "proxy_judge": "judge", "search_api": "judge",
        "synthesize": "synthesize",
    }

    def groups(self):
        """Merge CONSECUTIVE template components sharing an agent role
        (an agent handles several system modules, paper §7 baselines) —
        contiguity preserves the workflow's dataflow order."""
        out, cur, cur_role = [], [], None
        for n in self.app.template:
            role = self.ROLE_OF.get(n.name, n.name)
            if role == cur_role:
                cur.append(n.name)
            else:
                if cur:
                    out.append(cur)
                cur, cur_role = [n.name], role
        if cur:
            out.append(cur)
        return out
