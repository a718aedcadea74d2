"""Embedding and reranking engines wrapping the port's encoder models."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.engines.tokenizer import HashTokenizer
from repro_torch.models.encoder import (EMBEDDER, RERANKER, EncoderConfig,
                                        apply_encoder, init_encoder_params)

_BUCKETS_B = (1, 2, 4, 8, 16, 32)
_BUCKETS_S = (16, 32, 64)


def _bucket(n, bs):
    for b in bs:
        if n <= b:
            return b
    return bs[-1]


class _EncoderEngine:
    """Weights are drawn from ``seed`` with a ``torch.Generator`` on
    ``device`` (replace ``params`` to load others, e.g. from
    ``bridge.encoder_params``)."""

    def __init__(self, name, cfg: EncoderConfig, max_batch: int, seed=0, *,
                 device="cuda"):
        self.name = name
        self.cfg = cfg
        self.max_batch = max_batch
        self.device = torch.device(device)
        self.tok = HashTokenizer(cfg.vocab_size)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_encoder_params(cfg, gen, device=self.device)
        self.stats = {"requests": 0, "calls": 0}

    def clone(self, idx: int = 1):
        """Pool replica: shared weights/tokenizer, fresh stats (encoders
        are stateless across requests)."""
        c = type(self).__new__(type(self))
        c.name = f"{self.name}.r{idx}"
        c.cfg = self.cfg
        c.max_batch = self.max_batch
        c.device = self.device
        c.tok = self.tok
        c.params = self.params
        c.stats = {"requests": 0, "calls": 0}
        return c

    def _encode_batch(self, texts: List[str]):
        B = _bucket(len(texts), _BUCKETS_B)
        S = _bucket(max(1, max(len(t.split()) for t in texts)), _BUCKETS_S)
        toks = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), np.float32)
        for i, t in enumerate(texts):
            ids = self.tok.encode(t)[:S]
            toks[i, :len(ids)] = ids
            mask[i, :len(ids)] = 1.0
        with torch.inference_mode():
            out = tracing.readback(apply_encoder(
                self.cfg, self.params,
                torch.as_tensor(toks, device=self.device),
                torch.as_tensor(mask, device=self.device)).cpu).numpy()
        self.stats["requests"] += len(texts)
        self.stats["calls"] += 1
        return out[:len(texts)]


class EmbeddingEngine(_EncoderEngine):
    kind = "embedding"

    def __init__(self, name="embedding", max_batch=16, seed=0, *,
                 device="cuda"):
        super().__init__(name, EMBEDDER, max_batch, seed, device=device)

    def op_embed(self, tasks):
        """tasks: list of {'texts': [...]} -> list of vector arrays."""
        flat, spans = [], []
        for t in tasks:
            spans.append((len(flat), len(flat) + len(t["texts"])))
            flat.extend(t["texts"])
        vecs = self._encode_batch(flat) if flat else np.zeros((0, 1))
        return [vecs[a:b] for a, b in spans]


class RerankEngine(_EncoderEngine):
    kind = "rerank"

    def __init__(self, name="rerank", max_batch=16, seed=1, *,
                 device="cuda"):
        super().__init__(name, RERANKER, max_batch, seed, device=device)

    def op_rerank(self, tasks):
        """tasks: {'question', 'candidates': [{'text',...}], 'top_k'}."""
        out = []
        for t in tasks:
            cands = t["candidates"]
            if not cands:
                out.append([])
                continue
            pairs = [f"{t['question']} [SEP] {c['text']}" for c in cands]
            scores = self._encode_batch(pairs)          # (n,) cls scores
            order = np.argsort(-scores)[: t.get("top_k", 3)]
            out.append([{**cands[i], "rerank_score": float(scores[i])}
                        for i in order])
        return out
