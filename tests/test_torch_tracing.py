"""The port's tracer (``repro_torch.tracing``): nothing recorded while
off; on, one query of naive-RAG over a reduced Qwen1.5-MoE core LLM yields
the span tree query -> prim.wait / prim.run -> batch -> llm.decode ->
llm.step -> moe.dispatch (the grouped path, which reads nothing back),
with its ids and counts, every dispatch on the path the crossover gives
it; the buffer drops past its capacity; many threads write at once
without a lost or misparented record."""
import sys
import threading

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs.base import get_config
from repro_torch.core.apps import build_engines, naive_rag
from repro_torch.core.teola import Teola
from repro_torch.engines.llm_engine import LLMEngine
from repro_torch.models import moe
from repro_torch.training.data import doc_corpus

QUESTION = "what is fact 3 about optics"


def test_off_records_nothing():
    assert not tracing.enabled()
    assert tracing.span("x", qid="q") is tracing.NOOP
    assert tracing.span("y") is tracing.NOOP
    assert tracing.start("z") is None
    with tracing.span("x", rows=3):
        pass
    assert tracing.readback(torch.arange(3).tolist) == [0, 1, 2]
    tracing.record("prim.wait", 0, 1, qid="q")
    assert tracing.new_id() is None
    assert tracing.drain() == {"records": [], "dropped": 0}


@pytest.fixture(scope="module")
def traced():
    """One query of naive-RAG with a 2-layer MoE core LLM, traced."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    engines = build_engines(device="cpu")
    engines["core_llm"] = LLMEngine("core_llm", cfg, max_batch=4,
                                    device="cpu")
    teola = Teola(naive_rag(engines), engines)
    core = engines["core_llm"]
    iters0 = core.stats["decode_iters"]
    tracing.drain()
    tracing.enable()
    try:
        _, ctx = teola.query({"question": QUESTION, "docs": doc_corpus(2)},
                             timeout=300)
    finally:
        tracing.disable()
        teola.shutdown()
    out = tracing.drain()
    assert ctx.error is None
    return {"recs": out["records"], "dropped": out["dropped"], "ctx": ctx,
            "cfg": cfg, "iters": core.stats["decode_iters"] - iters0}


def _by(recs, name):
    return [r for r in recs if r["name"] == name]


def test_span_tree_of_one_query(traced):
    recs, ctx = traced["recs"], traced["ctx"]
    assert traced["dropped"] == 0
    ids = {r["id"]: r for r in recs}
    assert len(ids) == len(recs)
    (query,) = _by(recs, "query")
    assert query["qid"] == ctx.qid and query["parent"] is None
    runs = _by(recs, "prim.run")
    assert runs and all(r["parent"] == query["id"] and r["qid"] == ctx.qid
                        for r in runs + _by(recs, "prim.wait"))
    decodes = _by(recs, "llm.decode")
    assert decodes
    for dec in decodes:
        batch = ids[dec["parent"]]
        assert batch["name"] == "batch" and batch["engine"] == "core_llm"
        assert batch["op"] == "Decoding" and ctx.qid in batch["qids"]
        assert batch["rows"] == dec["rows"]
        assert any(r["batch"] == batch["id"] for r in runs)
        steps = [r for r in recs if r["name"] == "llm.step"
                 and r["parent"] == dec["id"]]
        assert [s["step"] for s in steps] == list(range(dec["steps"]))
        for st in steps:
            moes = [r for r in recs if r["parent"] == st["id"]
                    and r["name"] == "moe.dispatch"]
            assert len(moes) == traced["cfg"].num_layers
            for m in moes:
                # a decode step's experts run on the grouped path, which
                # reads nothing back and so cannot count the experts
                assert not [r for r in recs if r["parent"] == m["id"]]
                assert m["path"] == "grouped" and "experts" not in m
                assert m["T"] == dec["B"]
                assert st["start"] <= m["start"] and m["end"] <= st["end"]
    # every dispatch of the query (prefills too) is on the path its T*k
    # gives it; only the sorted path reads back
    k = traced["cfg"].moe.top_k
    for m in _by(recs, "moe.dispatch"):
        grouped = m["T"] * k <= moe.GROUPED_MAX_ASSIGN
        assert m["path"] == ("grouped" if grouped else "sorted")
        assert grouped == (not [r for r in recs if r["parent"] == m["id"]])
    assert {r["thread"] for r in _by(recs, "llm.step")} == \
        {r["thread"] for r in _by(recs, "batch")
         if r["engine"] == "core_llm"}


def test_readbacks_per_step_are_moe_layers_plus_one(traced):
    """A decode step reads back its tokens once; its MoE layers, on the
    grouped path, add none (the sorted path added one a layer)."""
    recs = traced["recs"]
    kids = {}
    for r in recs:
        kids.setdefault(r["parent"], []).append(r)

    def readbacks(r):
        return sum((c["name"] == "readback") + readbacks(c)
                   for c in kids.get(r["id"], []))
    steps = _by(recs, "llm.step")
    assert steps
    assert {readbacks(st) for st in steps} == {1}


def test_wait_and_run_make_up_each_node_span(traced):
    recs, ctx = traced["recs"], traced["ctx"]
    waits = {r["pid"]: r for r in _by(recs, "prim.wait")}
    runs = {r["pid"]: r for r in _by(recs, "prim.run")}
    assert waits.keys() == runs.keys()
    engine_pids = {pid for pid, n in ctx.graph.nodes.items()
                   if n.engine != "control"}
    assert set(waits) == engine_pids
    for pid, (t0, t1) in ctx.node_spans.items():
        if pid not in waits:
            continue
        w, r = waits[pid], runs[pid]
        assert w["start"] == tracing.ns(t0) and r["end"] == tracing.ns(t1)
        assert w["end"] == r["start"]
        assert (w["end"] - w["start"]) + (r["end"] - r["start"]) == \
            tracing.ns(t1) - tracing.ns(t0)


def test_decode_iters_counts_run_to_completion_steps(traced):
    steps = sum(d["steps"] for d in _by(traced["recs"], "llm.decode"))
    assert steps > 0 and traced["iters"] == steps


def test_busy_seconds_is_the_union_of_an_engines_spans():
    recs = [{"name": "batch", "engine": "e", "start": 0, "end": 4e9},
            {"name": "llm.decode", "engine": "e", "start": 1e9,
             "end": 5e9},
            {"name": "llm.step", "engine": "e", "start": 7e9, "end": 8e9},
            {"name": "prim.wait", "engine": "e", "start": 10e9,
             "end": 20e9},
            {"name": "batch", "engine": "f", "start": 0, "end": 1e9}]
    assert tracing.busy_seconds(recs) == {"e": 6.0, "f": 1.0}


def test_buffer_drops_past_its_capacity():
    tr = tracing.Tracer(capacity=3)
    tr.on = True
    for i in range(5):
        with tracing.Span(tr, f"s{i}", {}):
            pass
    out = tr.drain()
    assert [r["name"] for r in out["records"]] == ["s0", "s1", "s2"]
    assert out["dropped"] == 2
    assert tr.drain() == {"records": [], "dropped": 0}


def test_threads_keep_their_own_parents():
    """More writer threads than cores, a short switch interval: every
    span is kept and each child's parent is its own thread's span."""
    tr = tracing.Tracer(capacity=10_000)
    tr.on = True
    n_threads, n_spans = 16, 100

    def work():
        for _ in range(n_spans):
            with tracing.Span(tr, "outer", {}):
                with tracing.Span(tr, "inner", {}):
                    pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    out = tr.drain()
    recs = out["records"]
    assert out["dropped"] == 0 and len(recs) == 2 * n_threads * n_spans
    ids = {r["id"]: r for r in recs}
    assert len(ids) == len(recs)
    for r in recs:
        if r["name"] == "inner":
            parent = ids[r["parent"]]
            assert parent["name"] == "outer"
            assert parent["thread"] == r["thread"]
        else:
            assert r["parent"] is None
