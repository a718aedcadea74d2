"""Every app under every scheme, on the reference's real engines and on
the port's (CPU) engines holding the same weights: the four apps of
core/apps.py under Teola, LlamaDist, LlamaDistPC and AutoGenLike must give
the same answer and the same retrieved, reranked, expanded and
contextualized chunks (under Teola also the same e-graph), on the dense
path and, under Teola with continuous batching, on the paged serving path
(paged KV + radix cache, chunked prefill, k=3 prompt-lookup speculation).
Also: a pool of two replicas per LLM with streaming, the contextual-
retrieval fault both packages share, and a clean interpreter exit after a
shutdown."""
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import apps as rapps  # noqa: E402
from repro.core import engine_pool as rpool  # noqa: E402
from repro.core import teola as rteola  # noqa: E402
from repro.training.data import doc_corpus  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import apps as tapps  # noqa: E402
from repro_torch.core import engine_pool as tpool  # noqa: E402
from repro_torch.core import teola as tteola  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
Q = {"question": "what is fact 3 about optics", "docs": doc_corpus(2)}
APPS = ("naive_rag", "advanced_rag", "search_gen", "contextual_retrieval")
SCHEMES = ("Teola", "LlamaDist", "LlamaDistPC", "AutoGenLike")
# store keys an app fills with chunk or query lists
CHUNK_KEYS = ("retrieved", "top_chunks", "web_results", "expanded_queries",
              "ctx_chunks")
PAGED = dict(paged_kv=True, chunked_prefill=True, prefill_chunk=128,
             prefix_cache="radix")
PKG = {"ref": (rapps, rteola, rpool), "port": (tapps, tteola, tpool)}


def _engine_pair(**kw):
    """Both packages' engine sets, the port's holding the reference's
    weights."""
    ref = rapps.build_engines(**kw)
    port = tapps.build_engines(device="cpu", **kw)
    for name in ("core_llm", "lite_llm"):
        port[name].params = bridge.decoder_params(
            jax.tree.map(np.asarray, ref[name].params), port[name].cfg,
            "cpu")
    for name in ("embedding", "rerank"):
        port[name].params = bridge.encoder_params(
            jax.tree.map(np.asarray, ref[name].params), port[name].cfg,
            "cpu")
    return {"ref": ref, "port": port}


def _texts(v):
    if not isinstance(v, list):
        return v
    return [c.get("text") if isinstance(c, dict) else c for c in v]


def _run(pkg, engines, app, scheme, **kw):
    apps, teola, _ = PKG[pkg]
    orch = getattr(teola, scheme)(getattr(apps, app)(engines), engines,
                                  **kw)
    try:
        ops = Counter(n.op for n in orch.build_egraph(dict(Q)).nodes.values()
                      ) if scheme == "Teola" else None
        out, ctx = orch.query(dict(Q), timeout=600)
    finally:
        orch.shutdown()
    assert ctx.error is None
    assert isinstance(out, str) and out
    return {"answer": out, "ops": ops,
            **{k: _texts(ctx.store.get(k)) for k in CHUNK_KEYS}}


@pytest.fixture(scope="module")
def dense():
    """Two engine sets per package: LlamaDistPC turns every engine's
    prefix cache on for good (core/teola.py), so it runs on its own."""
    return {"main": _engine_pair(), "pc": _engine_pair(), "runs": {}}


def _cell(dense, app, scheme):
    key = (app, scheme)
    if key not in dense["runs"]:
        sets = dense["pc" if scheme == "LlamaDistPC" else "main"]
        dense["runs"][key] = {pkg: _run(pkg, sets[pkg], app, scheme)
                              for pkg in PKG}
    return dense["runs"][key]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("app", APPS)
def test_app_under_scheme_matches_reference(dense, app, scheme):
    got = _cell(dense, app, scheme)
    assert got["port"] == got["ref"]
    if app in ("naive_rag", "advanced_rag"):
        key = "retrieved" if app == "naive_rag" else "top_chunks"
        assert "optics" in " ".join(got["port"][key])


@pytest.fixture(scope="module")
def paged():
    """Both packages on the paged serving path, k=3 prompt-lookup
    speculation on the core LLM."""
    pair = _engine_pair(**PAGED)
    for engines in pair.values():
        engines["core_llm"].enable_speculative(draft=None, k=3)
    return pair


@pytest.mark.parametrize("app", APPS)
def test_app_on_paged_path_matches_reference(paged, app):
    got = {pkg: _run(pkg, paged[pkg], app, "Teola",
                     continuous_batching=True) for pkg in PKG}
    assert got["port"] == got["ref"]
    core = paged["port"]["core_llm"]
    for sid in list(core.states):
        core.release(sid)
    assert core.alloc.audit()["ok"]
    assert core.alloc.free_blocks() == \
        core.alloc.capacity - core.radix.num_blocks()


QUESTIONS = ["what is fact 3 about optics", "what is fact 7 about finance",
             "what is fact 12 about optics", "what is fact 30 about finance"]


def _pool_window(pkg, engines):
    apps, teola, pool = PKG[pkg]
    engines = pool.build_pools(engines, {"core_llm": 2, "lite_llm": 2})
    orch = teola.Teola(apps.advanced_rag(engines), engines, streaming=True)
    try:
        ctxs = [orch.submit({"question": q, "docs": doc_corpus(2)})
                for q in QUESTIONS]
        for c in ctxs:
            assert c.done.wait(300)
        routes = {r[0] for r in orch.runtime.scheds["core_llm"].routes}
    finally:
        orch.shutdown()
    assert all(c.error is None for c in ctxs)
    return [c.store["answer"] for c in ctxs], routes


def test_pool_of_two_with_streaming_matches_reference():
    """Four concurrent advanced-RAG queries over two replicas per LLM,
    decode chunks streamed downstream: both replicas serve, and every
    answer is the reference's."""
    pair = _engine_pair()
    got = {pkg: _pool_window(pkg, pair[pkg]) for pkg in PKG}
    assert got["port"][1] == {0, 1}
    assert all(isinstance(a, str) and a for a in got["port"][0])
    assert got["port"][0] == got["ref"][0]


def test_contextual_retrieval_fault_shared_with_reference(dense):
    """ROADMAP Queue 3: under Teola, Pass 2 splits contextualize's prefill
    -> decode chain into stages whose decode clones keep
    ``out_key="ctx_chunks"``, so the Aggregate finds nothing under the
    stage keys and ``ctx_chunks`` holds None. Both packages do this; the
    module-chain schemes hold the contextualized chunks."""
    teola = _cell(dense, "contextual_retrieval", "Teola")
    chain = _cell(dense, "contextual_retrieval", "LlamaDist")
    for pkg in PKG:
        assert teola[pkg]["ctx_chunks"] == [None, None]
        assert all(t == "" for t in teola[pkg]["top_chunks"])
        assert chain[pkg]["ctx_chunks"] and \
            all(isinstance(c, str) and c for c in chain[pkg]["ctx_chunks"])
        assert all(chain[pkg]["top_chunks"])


_EXIT_SCRIPT = """
import threading
from repro_torch.core.apps import build_engines, naive_rag
from repro_torch.core import teola
from repro_torch.training.data import doc_corpus
engines = build_engines(device="cpu")
orch = getattr(teola, "{scheme}")(naive_rag(engines), engines)
out, ctx = orch.query({{"question": "what is fact 3 about optics",
                       "docs": doc_corpus(2)}}, timeout=600)
assert ctx.error is None and out
orch.shutdown()
print("alive", [t.name for t in threading.enumerate()
                if t is not threading.main_thread()])
"""


@pytest.mark.parametrize("scheme", ["Teola", "LlamaDist"])
def test_shutdown_joins_every_thread_and_exits_cleanly(scheme):
    """After a query and ``shutdown()`` no thread the orchestrator started
    is alive, and the interpreter exits with 0: a daemon thread still
    inside torch at finalization aborts the process (rc 134,
    ``terminate called without an active exception``)."""
    proc = subprocess.run(
        [sys.executable, "-c", _EXIT_SCRIPT.format(scheme=scheme)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert "terminate called" not in proc.stderr, proc.stderr
    assert proc.returncode == 0, proc.stderr
    assert "alive []" in proc.stdout, proc.stdout
