"""The paper's application workflows (Figure 2) built on the template API,
plus a shared engine pool factory.

(a) search engine-empowered generation   (judge LLM -> search -> core LLM)
(c) document QA with naive RAG           (index ∥ query-embed -> search ->
                                          tree-mode synthesis)
(d) document QA with advanced RAG        (+ query expansion, rerank,
                                          refine-mode synthesis)
(e) contextual retrieval (Anthropic)     (chunk contextualization before
                                          indexing + rerank)
"""
from __future__ import annotations


from repro_torch.configs.base import get_config
from repro_torch.core.workflow import APP, EngineSpec, Node
from repro_torch.engines.encoder_engines import EmbeddingEngine, RerankEngine
from repro_torch.engines.llm_engine import LLMEngine
from repro_torch.engines.model_free import (ChunkerEngine, SearchAPIEngine,
                                            VectorDBEngine)


def build_engines(*, seed: int = 0, llm_max_batch: int = 4,
                  emb_max_batch: int = 16, paged_kv: bool = False,
                  kv_block_size: int = 16, chunked_prefill: bool = False,
                  prefill_chunk: int = 128, token_budget=None,
                  prefix_cache: str = "none", device="cuda"):
    """One shared pool (the paper co-locates apps on shared engines).
    ``paged_kv`` switches the LLM engines to the block-paged KV cache
    (copy-on-write prefix sharing, block-based occupancy/backpressure);
    ``chunked_prefill`` streams prompts through each LLM replica's
    continuous loop as budget-bounded chunks mixed with decode
    iterations (stall-free prefill); ``prefix_cache="radix"`` adds the
    global radix-tree prefix cache (any shared block-aligned prompt
    prefix reuses cached KV across queries; requires paged_kv).
    ``device`` places every model engine's weights and caches."""
    return {
        "core_llm": LLMEngine("core_llm", get_config("tiny-core-llm"),
                              seed=seed, max_batch=llm_max_batch,
                              paged=paged_kv, block_size=kv_block_size,
                              chunked_prefill=chunked_prefill,
                              prefill_chunk=prefill_chunk,
                              token_budget=token_budget,
                              prefix_cache=prefix_cache, device=device),
        "lite_llm": LLMEngine("lite_llm", get_config("tiny-lite-llm"),
                              seed=seed + 1, max_batch=llm_max_batch * 2,
                              paged=paged_kv, block_size=kv_block_size,
                              chunked_prefill=chunked_prefill,
                              prefill_chunk=prefill_chunk,
                              token_budget=token_budget,
                              prefix_cache=prefix_cache, device=device),
        "embedding": EmbeddingEngine(max_batch=emb_max_batch, device=device),
        "rerank": RerankEngine(max_batch=emb_max_batch, device=device),
        "vectordb": VectorDBEngine(),
        "chunker": ChunkerEngine(),
        "search_api": SearchAPIEngine(),
    }


def _register_common(app: APP, engines):
    for name, eng in engines.items():
        app.register_engine(EngineSpec.from_engine(name, eng))
    app.register_engine(EngineSpec(name="control", kind="control",
                                   max_batch=1 << 30))


def naive_rag(engines, *, num_chunks: int = 32, top_k: int = 3,
              tree_k: int = 3) -> APP:
    app = APP.init("doc_qa_naive_rag")
    _register_common(app, engines)
    chunk = Node("chunk", "chunker")
    index = Node("index", "embedding", name="indexing",
                 anno="batchable", config={"num_chunks": num_chunks})
    qemb = Node("query_embed", "embedding", name="query_embedding")
    search = Node("vector_search", "vectordb",
                  config={"top_k": top_k, "num_queries": 1})
    gen = Node("llm_generate", "core_llm", name="synthesize",
               config={"mode": "tree", "num_context": tree_k,
                       "context_key": "retrieved",
                       "degrade": {"min_new": 8}})
    chunk >> index >> qemb >> search >> gen
    app.update_template([chunk, index, qemb, search, gen])
    return app


def advanced_rag(engines, *, num_chunks: int = 32, num_expanded: int = 3,
                 search_k: int = 8, top_k: int = 3) -> APP:
    app = APP.init("doc_qa_advanced_rag")
    _register_common(app, engines)
    chunk = Node("chunk", "chunker")
    index = Node("index", "embedding", name="indexing",
                 anno="batchable", config={"num_chunks": num_chunks})
    expand = Node("llm_expand", "core_llm", name="query_expansion",
                  anno="splittable", config={"num_expanded": num_expanded,
                                             "max_new": 24})
    qemb = Node("query_embed", "embedding", name="query_embedding",
                config={"in_key": "expanded_queries",
                        "num_queries": num_expanded})
    search = Node("vector_search", "vectordb",
                  config={"top_k": search_k, "num_queries": num_expanded,
                          "degrade": {"min_top_k": 2}})
    rerank = Node("rerank", "rerank",
                  config={"top_k": top_k,
                          "num_candidates": search_k * num_expanded,
                          "degrade": {"skippable": True, "min_top_k": 1}})
    gen = Node("llm_generate", "core_llm", name="synthesize",
               config={"mode": "refine", "num_context": top_k,
                       "context_key": "top_chunks",
                       "degrade": {"min_new": 8, "chunk_cap": 64}})
    chunk >> index >> expand >> qemb >> search >> rerank >> gen
    app.update_template([chunk, index, expand, qemb, search, rerank, gen])
    return app


def search_gen(engines, *, web_k: int = 4) -> APP:
    app = APP.init("search_engine_generation")
    _register_common(app, engines)
    judge = Node("llm_judge", "lite_llm", name="proxy_judge",
                 config={"max_new": 8})
    sapi = Node("search_api", "search_api", config={"top_k": web_k})
    gen = Node("llm_generate", "core_llm", name="synthesize",
               config={"mode": "oneshot", "context_key": "web_results",
                       "max_new": 32, "degrade": {"min_new": 8}})
    judge >> sapi >> gen
    app.update_template([judge, sapi, gen])
    return app


def contextual_retrieval(engines, *, num_chunks: int = 32, search_k: int = 8,
                         top_k: int = 3) -> APP:
    app = APP.init("contextual_retrieval")
    _register_common(app, engines)
    chunk = Node("chunk", "chunker")
    ctx = Node("contextualize", "lite_llm", anno="batchable",
               config={"num_chunks": num_chunks, "max_new": 8})
    index = Node("index", "embedding", name="indexing", anno="batchable",
                 config={"num_chunks": num_chunks, "in_key": "ctx_chunks"})
    qemb = Node("query_embed", "embedding", name="query_embedding")
    search = Node("vector_search", "vectordb",
                  config={"top_k": search_k, "num_queries": 1})
    rerank = Node("rerank", "rerank",
                  config={"top_k": top_k, "num_candidates": search_k,
                          "degrade": {"skippable": True, "min_top_k": 1}})
    gen = Node("llm_generate", "core_llm", name="synthesize",
               config={"mode": "oneshot", "context_key": "top_chunks",
                       "degrade": {"min_new": 8}})
    chunk >> ctx >> index >> qemb >> search >> rerank >> gen
    app.update_template([chunk, ctx, index, qemb, search, rerank, gen])
    return app


ALL_APPS = {
    "naive_rag": naive_rag,
    "advanced_rag": advanced_rag,
    "search_gen": search_gen,
    "contextual_retrieval": contextual_retrieval,
}
