"""Naive-RAG under Teola with RWKV-6 (reduced) as the core LLM, on the
reference's real engines and on the port's (CPU) engines holding the same
weights: the same e-graph, the same retrieved chunks and the same answer
string. The core LLM serves through the dense engine path, its
per-sequence recurrent state in the dense cache; the other engines are
the tiny defaults of ``build_engines``."""
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.core.apps import build_engines, naive_rag  # noqa: E402
from repro.core.teola import Teola  # noqa: E402
from repro.engines.llm_engine import LLMEngine  # noqa: E402
from repro.training.data import doc_corpus  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.core import apps as tapps  # noqa: E402
from repro_torch.core.teola import Teola as TTeola  # noqa: E402
from repro_torch.engines.llm_engine import LLMEngine as TLLMEngine  # noqa: E402

Q = {"question": "what is fact 3 about optics", "docs": doc_corpus(2)}
NAME = "rwkv6-3b"


def _engines():
    """Both packages' engines, the port's holding the reference's weights,
    each with the reduced RWKV-6 as its core LLM."""
    ref = build_engines()
    ref["core_llm"] = LLMEngine("core_llm", get_config(NAME).reduced(),
                                seed=0, max_batch=4)
    port = tapps.build_engines(device="cpu")
    port["core_llm"] = TLLMEngine("core_llm", tget_config(NAME).reduced(),
                                  seed=0, max_batch=4, device="cpu")
    for name in ("core_llm", "lite_llm"):
        tree = jax.tree.map(np.asarray, ref[name].params)
        port[name].params = bridge.decoder_params(tree, port[name].cfg, "cpu")
    for name in ("embedding", "rerank"):
        tree = jax.tree.map(np.asarray, ref[name].params)
        port[name].params = bridge.encoder_params(tree, port[name].cfg, "cpu")
    return ref, port


def _run(teola_cls, engines):
    teola = teola_cls(naive_rag(engines) if teola_cls is Teola
                      else tapps.naive_rag(engines), engines)
    try:
        g = teola.build_egraph(dict(Q))
        out, ctx = teola.query(dict(Q), timeout=600)
    finally:
        teola.shutdown()
    assert ctx.error is None
    core = engines["core_llm"].stats
    return {"ops": Counter(n.op for n in g.nodes.values()),
            "retrieved": [c["text"] for c in ctx.store["retrieved"]],
            "answer": out,
            "tokens": (core["prefill_tokens"], core["decode_tokens"])}


@pytest.fixture(scope="module")
def runs():
    ref, port = _engines()
    return {"ref": _run(Teola, ref), "port": _run(TTeola, port)}


def test_rwkv_naive_rag_same_egraph_and_chunks(runs):
    assert runs["port"]["ops"] == runs["ref"]["ops"]
    assert runs["port"]["retrieved"] == runs["ref"]["retrieved"]
    assert "optics" in " ".join(runs["port"]["retrieved"])


def test_rwkv_naive_rag_same_answer(runs):
    ans = runs["port"]["answer"]
    assert isinstance(ans, str) and ans
    assert ans == runs["ref"]["answer"]
    assert runs["port"]["tokens"] == runs["ref"]["tokens"]
    assert runs["port"]["tokens"][1] > 0
