"""The one traffic generator: a mix file's parameters and ``--seed`` in,
queries and their send times out.

A mix (``bench/traffic/<name>.json``) gives the app, the open loop's
rate (``rate_qps``) and drain (``drain_s``) and the documents'
popularity. Every query carries ``docs_per_query``
documents drawn without replacement from a pool of ``docs_pool``
documents by Zipf popularity (exponent ``zipf_s``), and asks for one
fact about the topic of its first document.

The work does not change with the seed, only which query comes when and
the documents' values: the mix's own ``shape_seed`` fixes the list of
document pairs (so every seed sends the same chunk counts and prompt
lengths) and an open loop's send times (the exponential distribution's
quantiles as gaps, so the rate is exact, in an order the shape seed
draws: one Poisson trace that every run replays). The run's seed
shuffles the queries over it, picks each question's fact and draws the
documents' values.
"""
from __future__ import annotations

import numpy as np

from harness.corpus import FACTS, doc_corpus

def _rng(*keys) -> np.random.Generator:
    return np.random.default_rng([int(k) % 2 ** 63 for k in keys])


class Traffic:
    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.docs = doc_corpus(int(mix["docs_pool"]), self.seed)

    def _pairs(self, n: int) -> list:
        """``n`` document-index tuples from the mix's fixed list, in the
        seed's order."""
        k, pool = int(self.mix["docs_per_query"]), int(self.mix["docs_pool"])
        pop = 1.0 / np.arange(1, pool + 1) ** float(self.mix["zipf_s"])
        shape = _rng(self.mix["shape_seed"])
        pairs = [tuple(int(i) for i in shape.choice(pool, k, replace=False,
                                                    p=pop / pop.sum()))
                 for _ in range(n)]
        order = _rng(self.seed, 1).permutation(n)
        return [pairs[i] for i in order]

    def queries(self, n: int) -> list:
        """The first ``n`` queries: {"question", "docs", "doc_ids"}."""
        facts = _rng(self.seed, 2).integers(0, FACTS, n)
        out = []
        for pair, j in zip(self._pairs(n), facts):
            docs = [self.docs[i] for i in pair]
            out.append({"question": f"what is fact {int(j)} about "
                                    f"{docs[0]['topic']}",
                        "docs": docs, "doc_ids": [d["id"] for d in docs]})
        return out

    def open_schedule(self, seconds: float) -> np.ndarray:
        """Send offsets (s from the window's start) of an open loop at
        ``rate_qps``: round(rate x seconds) sends, whose gaps are the
        exponential quantiles (i + 0.5) / n scaled to fill the window
        exactly, in the mix's fixed order. The first send is at 0."""
        rate = float(self.mix["rate_qps"])
        n = max(1, int(round(rate * seconds)))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
        gaps *= seconds / gaps.sum()
        gaps = _rng(self.mix["shape_seed"], 3).permutation(gaps)
        return np.concatenate([[0.0], np.cumsum(gaps[:-1])])
