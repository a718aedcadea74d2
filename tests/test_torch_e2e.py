"""The slices end to end: one naive-RAG query under Teola on the
reference's real engines and on the port's (CPU) engines holding the same
weights. Both must build the same e-graph, retrieve the same chunks and
decode the same answer tokens — on the dense path, and on the paged
serving path (paged KV + radix prefix cache, chunked prefill, prompt-
lookup speculative decoding) under continuous batching."""
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.apps import build_engines, naive_rag  # noqa: E402
from repro.core.teola import Teola  # noqa: E402
from repro.training.data import doc_corpus  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import apps as tapps  # noqa: E402
from repro_torch.core.teola import Teola as TTeola  # noqa: E402

Q = {"question": "what is fact 3 about optics", "docs": doc_corpus(2)}


PAGED = dict(paged_kv=True, chunked_prefill=True, prefill_chunk=128,
             prefix_cache="radix")


def _port_engines_like(ref, **kw):
    """The port's engines dict, each model engine holding the reference
    engine's weights."""
    port = tapps.build_engines(device="cpu", **kw)
    for name in ("core_llm", "lite_llm"):
        tree = jax.tree.map(np.asarray, ref[name].params)
        port[name].params = bridge.decoder_params(tree, port[name].cfg, "cpu")
    for name in ("embedding", "rerank"):
        tree = jax.tree.map(np.asarray, ref[name].params)
        port[name].params = bridge.encoder_params(tree, port[name].cfg, "cpu")
    return port


def _run(teola_cls, engines, **kw):
    teola = teola_cls(naive_rag(engines) if teola_cls is Teola
                      else tapps.naive_rag(engines), engines, **kw)
    try:
        g = teola.build_egraph(dict(Q))
        out, ctx = teola.query(dict(Q), timeout=600)
    finally:
        teola.shutdown()
    assert ctx.error is None
    return {"ops": Counter(n.op for n in g.nodes.values()),
            "retrieved": [c["text"] for c in ctx.store["retrieved"]],
            "answer": out}


@pytest.fixture(scope="module")
def runs():
    ref = build_engines()
    port = _port_engines_like(ref)
    return {"ref": _run(Teola, ref), "port": _run(TTeola, port),
            "port_engines": port}


def test_naive_rag_same_egraph(runs):
    assert runs["port"]["ops"] == runs["ref"]["ops"]


def test_naive_rag_same_retrieved_chunks(runs):
    assert runs["port"]["retrieved"] == runs["ref"]["retrieved"]
    assert "optics" in " ".join(runs["port"]["retrieved"])


def test_naive_rag_same_answer_tokens(runs):
    ans = runs["port"]["answer"]
    assert isinstance(ans, str) and ans
    assert ans == runs["ref"]["answer"]


def test_port_continuous_batching_same_answer(runs):
    """Decodes admitted into the engines' continuous loop emit the same
    tokens as the run-to-completion batches."""
    got = _run(TTeola, runs["port_engines"], continuous_batching=True)
    assert got["answer"] == runs["port"]["answer"]


@pytest.fixture(scope="module")
def paged_runs():
    """Both packages on the paged serving path: paged + chunked + radix
    engines, k=3 prompt-lookup speculation on the core LLM, continuous
    batching."""
    ref = build_engines(**PAGED)
    port = _port_engines_like(ref, **PAGED)
    for engines in (ref, port):
        engines["core_llm"].enable_speculative(draft=None, k=3)
    return {"ref": _run(Teola, ref, continuous_batching=True),
            "port": _run(TTeola, port, continuous_batching=True),
            "port_engines": port}


def test_naive_rag_paged_path_same_answer_as_reference(paged_runs):
    got, want = paged_runs["port"], paged_runs["ref"]
    assert got["ops"] == want["ops"]
    assert got["retrieved"] == want["retrieved"]
    assert isinstance(got["answer"], str) and got["answer"]
    assert got["answer"] == want["answer"]


def test_naive_rag_paged_path_same_answer_as_dense(runs, paged_runs):
    """The paged serving path decodes the dense path's tokens, through
    chunked prefill and verified speculative chunks, and leaks no
    block."""
    assert paged_runs["port"]["answer"] == runs["port"]["answer"]
    core = paged_runs["port_engines"]["core_llm"]
    assert core.spec.stats["target_steps"] > 0
    assert core._decode_loop is None or not core._decode_loop.is_alive()
    for sid in list(core.states):
        core.release(sid)
    held = core.radix.num_blocks()
    assert core.alloc.free_blocks() == core.alloc.capacity - held
    assert core.alloc.audit()["ok"]
