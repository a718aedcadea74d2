"""What decides ``correct``: the timed path's own outputs against the plain
reference, once the window has closed.

The numbers compared, each against its limit from the configuration file
(``limits``):

- ``token_gap_mean``: a sample of the queries the window finished, drawn
  from the seed with the one whose core-LLM generations are longest in
  it; for every generation of those queries the reference runs once over
  the context the sequence's prefills wrote and the served tokens (the
  token its prefill chose, then each decoded one), and reads at each
  served position how far the served token's logit lies below the
  reference's best. The mean over the served tokens. (The widest gap,
  logged beside it, swings with Qwen's router: where the port and the
  reference pick another expert at a near-tie, one token reads ~1e-2.)
- ``embed_err``: a seeded sample of the texts the embedding engine encoded
  in the window: the largest |program - reference| over their vectors'
  elements.
- ``retrieval_err``: a seeded sample of the window's vector searches: the
  reference embeds the query's text and the collection's chunks; for each
  chunk the program returned, the larger of how far its cosine in the
  reference lies below the reference's k-th best (a wrong chunk) and how
  far the score the program returned lies from that cosine. The largest.
- ``rerank_err``: the same for a seeded sample of the reranker's choices,
  on the reference reranker's scores.

A number that has nothing to read (no rerank in the app) is left out.
"""
from __future__ import annotations

import numpy as np
import torch

from harness import reference
from harness.corpus import HashTokenizer

MIN_SERVED = 400          # served tokens the token sample reaches at least
SAMPLE_TEXTS = 64
SAMPLE_SEARCHES = 16
SAMPLE_RERANKS = 16


def sample_generations(gens: dict, finished: list, seed: int) -> list:
    """Generations of a seeded sample of ``finished`` query ids, the query
    with the most served tokens first, until MIN_SERVED tokens."""
    served = {q: sum(len(g["served"]) for g in gens.get(q, ()))
              for q in finished}
    pool = [q for q in finished if served[q] > 0]
    if not pool:
        return []
    longest = max(pool, key=lambda q: (served[q], q))
    rng = np.random.default_rng([seed % 2 ** 63, 11])
    rest = [q for q in pool if q != longest]
    order = [longest] + [rest[i] for i in rng.permutation(len(rest))]
    out, total = [], 0
    for q in order:
        out.extend(gens[q])
        total += served[q]
        if total >= MIN_SERVED:
            break
    return out


def token_gap(conf, params, sample) -> tuple:
    """(mean gap, widest gap, served tokens read) of the sampled
    generations against the reference."""
    widest, total, n = 0.0, 0.0, 0
    for g in sample:
        seq = list(g["ctx"]) + list(g["served"][:-1])
        logits = reference.decoder_logits(conf, params, seq)
        pos = torch.arange(len(g["ctx"]) - 1, len(seq), device=logits.device)
        rows = logits[pos]
        tok = torch.as_tensor(g["served"], device=logits.device)
        gap = rows.max(-1).values - rows.gather(1, tok[:, None])[:, 0]
        widest = max(widest, float(gap.max()))
        total += float(gap.sum())
        n += len(g["served"])
    return total / n, widest, n


def _pick(items, k, seed, stream):
    rng = np.random.default_rng([seed % 2 ** 63, stream])
    if len(items) <= k:
        return list(items)
    return [items[i] for i in sorted(rng.choice(len(items), k,
                                                replace=False))]


def _worst(ref: dict, k: int, picked) -> float:
    """The largest, over the (text, score) pairs a program picked as its
    top ``k``, of how far each lies below the reference's k-th best and
    how far its score lies from the reference's."""
    kth = sorted(ref.values(), reverse=True)[k - 1]
    return max(max(kth - ref[t], abs(v - ref[t])) for t, v in picked)


def retrieval_checks(conf, enc_params, rec, seed, control=None) -> dict:
    """embed_err, retrieval_err and rerank_err from the encoder, vector
    search and rerank records of the window (``system.Capture``). With
    ``control`` (a dtype) the reference computed in that dtype stands in
    the program's place: its vectors, its top-k chunks, its reranking."""
    out = {}
    emb_conf, rr_conf = conf["encoders"]["embedding"], \
        conf["encoders"]["rerank"]
    tok = HashTokenizer(emb_conf["vocab_size"])
    rtok = HashTokenizer(rr_conf["vocab_size"])
    memo = {}

    def vec(text, dtype=torch.float32):
        key = (text, dtype)
        if key not in memo:
            memo[key] = reference.encode(emb_conf, enc_params["embedding"],
                                         tok.encode(text),
                                         dtype).cpu().numpy()
        return memo[key]

    def score(question, text, dtype=torch.float32):
        return float(reference.encode(
            rr_conf, enc_params["rerank"],
            rtok.encode(f"{question} [SEP] {text}"), dtype))

    def cos(a, b) -> float:
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    def top(values: dict, k: int) -> list:
        return sorted(values, key=lambda c: -values[c])[:k]

    texts = sorted(rec["embedded"])
    if texts:
        err = 0.0
        for t in _pick(texts, SAMPLE_TEXTS, seed, 12):
            got = [vec(t, control)] if control else rec["embedded"][t]
            for g in got:
                err = max(err, float(np.abs(np.asarray(g) - vec(t)).max()))
        out["embed_err"] = err
    if rec["searches"]:
        widest = 0.0
        for s in _pick(rec["searches"], SAMPLE_SEARCHES, seed, 13):
            qtext = rec["vec_text"].get(s["qkey"])
            chunks = sorted(set(rec["collections"].get(s["collection"], [])))
            if qtext is None or not chunks:
                raise AssertionError(f"search of {s['collection']}: no "
                                     f"recorded query text or collection")
            k = min(s["top_k"], len(chunks))
            sims = {c: cos(vec(c), vec(qtext)) for c in chunks}
            hits = s["hits"]
            if control:
                low = {c: cos(vec(c, control), vec(qtext, control))
                       for c in chunks}
                hits = [(c, low[c]) for c in top(low, k)]
            widest = max(widest, _worst(sims, k, hits))
        out["retrieval_err"] = widest
    if rec["reranks"]:
        widest = 0.0
        for r in _pick(rec["reranks"], SAMPLE_RERANKS, seed, 14):
            cands = sorted(set(r["candidates"]))
            k = min(r["top_k"], len(cands))
            sc = {c: score(r["question"], c) for c in cands}
            chosen = r["chosen"]
            if control:
                low = {c: score(r["question"], c, control) for c in cands}
                chosen = [(c, low[c]) for c in top(low, k)]
            widest = max(widest, _worst(sc, k, chosen))
        out["rerank_err"] = widest
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number within its limit;
    a number with no limit fails."""
    rows = [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = all(lim is not None and v <= lim for _, v, lim in rows)
    return ok and bool(rows), rows
