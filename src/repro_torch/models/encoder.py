"""Bidirectional encoder models for the embedding and reranking engines
(BERT-family stand-ins for bge-large-en / bge-reranker-large). PyTorch
counterpart of ``repro/models/encoder.py``."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.common import (act_fn, dense_init, embed_init,
                                       rms_norm)


@dataclass(frozen=True)
class EncoderConfig:
    name: str = "tiny-embedder"
    vocab_size: int = 4096
    d_model: int = 128
    num_heads: int = 4
    d_ff: int = 384
    num_layers: int = 2
    max_len: int = 512
    out_dim: int = 128          # embedding dim (embedder) / 1 (reranker)
    pooling: str = "mean"       # mean | cls_score
    norm_eps: float = 1e-6


EMBEDDER = EncoderConfig(name="tiny-embedder", out_dim=128, pooling="mean")
RERANKER = EncoderConfig(name="tiny-reranker", out_dim=1,
                         pooling="cls_score")


def init_encoder_params(cfg: EncoderConfig, generator: torch.Generator,
                        dtype=torch.float32, device="cuda"):
    """Random weights with the reference initializer's shapes and scales."""
    d = cfg.d_model

    def dense(shape):
        return dense_init(generator, shape, dtype, device)

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=device)

    params = {
        "embed": embed_init(generator, (cfg.vocab_size, d), dtype, device),
        "pos_embed": embed_init(generator, (cfg.max_len, d), dtype, device),
        "final_norm": zeros(),
        "head": dense((d, cfg.out_dim)),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1": zeros(), "ln2": zeros(),
            "wq": dense((d, d)), "wk": dense((d, d)), "wv": dense((d, d)),
            "wo": dense((d, d)),
            "w1": dense((d, cfg.d_ff)), "w2": dense((cfg.d_ff, d)),
        })
    return params


def apply_encoder(cfg: EncoderConfig, params, tokens, mask=None):
    """tokens (B,S) int; mask (B,S) 1=real, 0=pad. Returns:
    pooling=='mean': L2-normalized embeddings (B, out_dim)
    pooling=='cls_score': relevance scores (B,)"""
    B, S = tokens.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    mask = mask.float()
    gelu = act_fn("gelu")
    x = params["embed"][tokens.long()] + params["pos_embed"][:S]
    hd = cfg.d_model // cfg.num_heads
    for lp in params["layers"]:
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = (h @ lp["wq"]).reshape(B, S, cfg.num_heads, hd)
        k = (h @ lp["wk"]).reshape(B, S, cfg.num_heads, hd)
        v = (h @ lp["wv"]).reshape(B, S, cfg.num_heads, hd)
        s = torch.einsum("bshd,bthd->bhst", q, k) * hd ** -0.5
        s = torch.where(mask[:, None, None, :] > 0, s, -1e30)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhst,bthd->bshd", p, v).reshape(B, S, cfg.d_model)
        x = x + o @ lp["wo"]
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + gelu(h @ lp["w1"]) @ lp["w2"]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.pooling == "mean":
        pooled = torch.sum(x * mask[..., None], dim=1) / (
            torch.sum(mask, dim=1, keepdim=True) + 1e-6)
        emb = pooled @ params["head"]
        return emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-6)
    # reranker: score from first token
    return (x[:, 0] @ params["head"]).squeeze(-1)
