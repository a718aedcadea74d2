"""The readers of the program's spans (``harness/program.py`` and the
``metrics/`` files that read ``run["program"]``) on records built by
hand; the port's tracer through ``program.start`` / ``collect``; and, on
a card, that the spans and the profiler's device records share one
clock."""
import importlib.util

import pytest

from .benchtree import BENCH
from harness import program

READERS = ("queue_wait_ms", "llm_batch_rows", "decode_host_ms",
           "decode_device_ms", "moe_dispatch_ms", "host_syncs_per_step",
           "idle_in_step_share")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(i, name, a, b, parent=None, thread=1, **kw):
    return {"id": i, "name": name, "start": a, "end": b, "parent": parent,
            "thread": thread, **kw}


def _step(i, parent, a, b, moe, rb_in_moe, rb):
    """A decode step [a, b]: one moe.dispatch with its readback, then the
    token readback."""
    return [_span(i, "llm.step", a, b, parent, step=0),
            _span(i + 1, "moe.dispatch", *moe, i, T=4, experts=3),
            _span(i + 2, "readback", *rb_in_moe, i + 1),
            _span(i + 3, "readback", *rb, i)]


def _run():
    """One answered query q0 whose decode batch holds four steps: one
    before the slice [10, 11], one across its start, one inside, one
    after; an embedding batch on another thread; device busy three times
    in the slice."""
    recs = [_span(1, "query", 1.0, 20.0, qid="q0"),
            _span(2, "batch", 2.0, 14.0, engine="core_llm", op="Decoding",
                  rows=3, qids=["q0"]),
            _span(3, "llm.decode", 2.0, 14.0, 2, engine="core_llm", rows=3,
                  B=4, steps=4)]
    recs += _step(4, 3, 3.0, 3.1, (3.0, 3.06), (3.04, 3.05), (3.08, 3.1))
    recs += _step(8, 3, 9.95, 10.05, (9.95, 10.0), (9.99, 10.0),
                  (10.04, 10.05))
    recs += _step(12, 3, 10.2, 10.4, (10.2, 10.3), (10.28, 10.3),
                  (10.38, 10.4))
    recs += _step(16, 3, 12.0, 12.2, (12.0, 12.1), (12.05, 12.1),
                  (12.15, 12.2))
    recs += [_span(20, "batch", 10.45, 10.55, thread=2, engine="embedding",
                   op="Embedding", rows=5, qids=["q0"]),
             _span(21, "batch", 15.0, 16.0, engine="core_llm",
                   op="Decoding", rows=1, qids=["q0"]),
             _span(22, "batch", 0.5, 0.9, engine="core_llm",
                   op="FullPrefilling", rows=4, qids=["q0"])]
    pw = dict(parent=1, qid="q0", thread=1)
    recs += [_span(30, "prim.wait", 1.0, 1.5, pid="p0", **pw),
             _span(31, "prim.run", 1.5, 1.9, pid="p0", **pw),
             _span(32, "prim.wait", 1.0, 2.0, pid="d1", **pw),
             _span(33, "prim.run", 2.0, 14.0, pid="d1", batch=2, **pw),
             _span(34, "prim.wait", 14.5, 15.0, pid="d2", **pw),
             _span(35, "prim.run", 15.0, 16.0, pid="d2", batch=21, **pw)]
    queries = [{"qid": "q0", "ok": True, "submit": 1.0, "done": 20.0},
               {"qid": "q1", "ok": False, "submit": 2.0, "done": None},
               {"qid": "q2", "ok": True, "submit": 3.0, "done": 4.0}]
    busy = [(10.25, 10.28), (10.3, 10.35), (10.5, 10.6)]
    return {"window": (0.0, 30.0), "queries": queries,
            "program": {"records": recs, "dropped": 0},
            "slice": {"t0": 10.0, "t1": 11.0, "busy": busy}}


@pytest.mark.parametrize("name,want", [
    # q0: waits [1, 2] and [14.5, 15] less runs [1.5, 1.9], [2, 14],
    # [15, 16]: 0.5 + 0.1 + 0.5 s; q1 failed, q2 has no spans
    ("queue_wait_ms", 1100.0),
    # the core LLM's decode batches: 3 and 1 rows (its prefill left out)
    ("llm_batch_rows", 2.0),
    # the steps outside the slice: 0.1 - 0.01 - 0.02 and 0.2 - 0.05 - 0.05
    ("decode_host_ms", 85.0),
    # the one step inside the slice, [10.2, 10.4]: 0.03 + 0.05 busy
    ("decode_device_ms", 80.0),
    # the steps outside the slice: 0.06 and 0.1
    ("moe_dispatch_ms", 80.0),
    # every step, the one across the slice's edge too: 8 / 4
    ("host_syncs_per_step", 2.0),
    # idle 0.82 s of the slice, 0.05 + 0.05 + 0.02 + 0.05 inside steps
    ("idle_in_step_share", 100.0 * 0.17 / 0.82)])
def test_reader_on_hand_built_records(name, want):
    assert _reader(name)(_run()) == pytest.approx(want, rel=1e-9)


def test_host_readers_leave_out_a_step_across_the_slice_edge():
    run = _run()
    # only the step across the slice's start: no step is wholly outside
    run["program"]["records"] = [r for r in run["program"]["records"]
                                 if r["id"] < 4 or 8 <= r["id"] < 12]
    assert _reader("decode_host_ms")(run) is None
    assert _reader("moe_dispatch_ms")(run) is None
    assert _reader("decode_device_ms")(run) is None
    assert _reader("host_syncs_per_step")(run) == 2.0


@pytest.mark.parametrize("name", READERS)
def test_reader_without_program_records(name):
    """A run of a harness or a port that records no spans: nothing to
    read."""
    run = _run()
    del run["program"]
    run["slice"] = {"seconds": 1.0, "summary": {"busy_s": 0.1}}
    assert _reader(name)(run) is None


@pytest.mark.parametrize("name", ["decode_device_ms", "idle_in_step_share"])
def test_device_readers_without_device_records(name):
    """A profile with no device activity (a run on the CPU): the device
    readers and the idle breakdown have nothing to read."""
    run = _run()
    run["slice"]["busy"] = []
    assert _reader(name)(run) is None
    assert program.idle_by_span(run) is None


def test_idle_by_span_names_what_the_core_llm_thread_was_doing():
    got = dict(program.idle_by_span(_run()))
    assert got == pytest.approx({"llm.decode": 0.65, "llm.step": 0.07,
                                 "readback": 0.05, "moe.dispatch": 0.05})
    assert sum(got.values()) == pytest.approx(0.82)


def test_idle_by_span_other_batches_then_nothing():
    run = _run()
    # a slice after the core LLM's last batch: an embedding batch on its
    # own thread, then no engine call
    run["program"]["records"].append(
        _span(40, "batch", 16.2, 16.5, thread=2, engine="embedding",
              op="Embedding", rows=2, qids=["q0"]))
    run["slice"] = {"t0": 16.0, "t1": 17.0, "busy": [(16.9, 17.0)]}
    got = dict(program.idle_by_span(run))
    assert got == pytest.approx({"batch:embedding": 0.3,
                                 "no engine call": 0.6})
    assert list(got) == ["no engine call", "batch:embedding"]


def test_start_and_collect_take_the_ports_spans():
    from repro_torch import tracing
    assert program.start()
    try:
        with tracing.span("batch", engine="core_llm"):
            pass
    finally:
        out = program.collect()
    assert not tracing.enabled()
    (r,) = out["records"]
    assert r["name"] == "batch" and out["dropped"] == 0
    assert 0 <= r["end"] - r["start"] < 1.0 and r["start"] > 1e9


def test_slice_fields_merge_the_device_records():
    recs = [("a", 0.5, 1.2), ("b", 1.1, 1.3), ("c", 1.5, 1.6),
            ("d", 2.9, 3.5)]
    assert program.slice_fields(recs, 1.0, 3.0) == {
        "t0": 1.0, "t1": 3.0, "busy": [(1.0, 1.3), (1.5, 1.6), (2.9, 3.0)]}


@pytest.mark.cuda
def test_spans_and_device_records_share_one_clock(cuda_card):
    """A span around a matrix product and the read of one of its values
    holds the product's and the copy's device records, to 50 us at each
    edge: the spans' clock is the profiler's."""
    import torch
    from harness.trace import device_records, profiler
    from repro_torch import tracing
    x = torch.randn(8192, 8192, device="cuda")
    (x @ x).sum().item()
    torch.cuda.synchronize()
    prof = profiler()
    prof.start()
    tracing.drain()
    tracing.enable()
    try:
        with tracing.span("probe"):
            y = x @ x
            tracing.readback(y[0, 0].item)
    finally:
        tracing.disable()
    torch.cuda.synchronize()
    prof.stop()
    (sp,) = [r for r in tracing.drain()["records"] if r["name"] == "probe"]
    a, b = sp["start"] / 1e9, sp["end"] / 1e9
    recs = device_records(prof)
    assert any("gemm" in n.lower() or "sgemm" in n.lower()
               for n, _, _ in recs), [n for n, _, _ in recs]
    first, last = min(s for _, s, _ in recs), max(e for _, _, e in recs)
    slack = 50e-6
    assert a - slack <= first and last <= b + slack, \
        (first - a, b - last)
    # the product runs for milliseconds: a clock offset past the slack
    # would push one edge of it out of the span
    assert last - first > 1e-3
