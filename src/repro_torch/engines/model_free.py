"""Model-free engines (CPU): vector DB, chunker, search-API stub.

All three support ``clone()`` so they can sit behind an EnginePool: the
vector DB's replicas SHARE the collection store (an ingest on one replica
is visible to a search on another — the pool models extra query
parallelism over one index, not a sharded index); chunker and search-API
replicas are stateless."""
from __future__ import annotations

import copy
import threading
import time
from typing import Dict

import numpy as np


class VectorDBEngine:
    """Exact cosine top-k vector store (pgvector stand-in). Collections are
    per-query (the RAG workflows ingest the user's docs per request)."""
    kind = "vectordb"

    def __init__(self, name: str = "vectordb", max_batch: int = 64,
                 ingest_latency_per_vec: float = 0.0002,
                 search_latency: float = 0.002):
        self.name = name
        self.max_batch = max_batch
        self._store: Dict[str, list] = {}
        self._lock = threading.Lock()
        self.ingest_lat = ingest_latency_per_vec
        self.search_lat = search_latency

    def op_ingest(self, tasks):
        for t in tasks:
            vecs, meta = t["vectors"], t["meta"]
            with self._lock:
                col = self._store.setdefault(t["collection"], [])
                for v, m in zip(vecs, meta):
                    col.append((np.asarray(v, np.float32), m))
            time.sleep(self.ingest_lat * len(vecs))
        return [True] * len(tasks)

    def op_search(self, tasks):
        out = []
        for t in tasks:
            with self._lock:
                col = list(self._store.get(t["collection"], []))
            time.sleep(self.search_lat)
            if not col:
                out.append([])
                continue
            mat = np.stack([v for v, _ in col])
            q = np.asarray(t["query_vec"], np.float32)
            sims = mat @ q / (np.linalg.norm(mat, axis=1)
                              * np.linalg.norm(q) + 1e-9)
            top = np.argsort(-sims)[: t.get("top_k", 3)]
            out.append([{**col[i][1], "score": float(sims[i])}
                        for i in top])
        return out

    def drop(self, collection: str):
        with self._lock:
            self._store.pop(collection, None)

    def clone(self, idx: int = 1):
        c = copy.copy(self)             # shares _store and _lock
        c.name = f"{self.name}.r{idx}"
        return c


class ChunkerEngine:
    """Word-window chunker (LlamaIndex text-splitter stand-in)."""
    kind = "chunker"

    def __init__(self, name: str = "chunker", max_batch: int = 8):
        self.name = name
        self.max_batch = max_batch

    def clone(self, idx: int = 1):
        c = copy.copy(self)
        c.name = f"{self.name}.r{idx}"
        return c

    @staticmethod
    def count_chunks(docs, chunk_size=48, overlap=8) -> int:
        n = 0
        step = max(1, chunk_size - overlap)
        for doc in docs:
            w = len(doc["text"].split())
            n += len(range(0, max(1, w - overlap), step))
        return n

    def op_chunk(self, tasks):
        out = []
        for t in tasks:
            words_per = t.get("chunk_size", 48)
            overlap = t.get("overlap", 8)
            chunks = []
            for doc in t["docs"]:
                w = doc["text"].split()
                step = max(1, words_per - overlap)
                for i in range(0, max(1, len(w) - overlap), step):
                    piece = " ".join(w[i:i + words_per])
                    if piece:
                        chunks.append({"doc_id": doc["id"], "text": piece})
            out.append(chunks)
        return out


class SearchAPIEngine:
    """Web-search stub (offline container): deterministic results with a
    network-latency model. The one permitted non-modality stub, DESIGN.md."""
    kind = "search_api"

    def __init__(self, name: str = "search_api", max_batch: int = 4,
                 latency: float = 0.05):
        self.name = name
        self.max_batch = max_batch
        self.latency = latency

    def clone(self, idx: int = 1):
        c = copy.copy(self)
        c.name = f"{self.name}.r{idx}"
        return c

    def op_search(self, tasks):
        time.sleep(self.latency)   # one batched API round-trip
        out = []
        for t in tasks:
            q = t["question"]
            out.append([{"doc_id": f"web{i}",
                         "text": f"web result {i} for {q}"}
                        for i in range(t.get("top_k", 4))])
        return out
