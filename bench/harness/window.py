"""The measured window: an open loop (sends on a fixed schedule whatever
the system does) and, in traced runs, the profiled slice.

Every query is timed from its scheduled send time, not from when
``submit`` ran, so a stalled generator shows in the latencies of the
queries it delayed; how late each send ran is kept beside it.
"""
from __future__ import annotations

import time

def _answered(ctx) -> bool:
    ans = ctx.store.get(ctx.output_key)
    return ctx.error is None and isinstance(ans, str) and bool(ans.strip())


def _submit(teola, q):
    return teola.submit({"question": q["question"], "docs": q["docs"]})


def _record(sched, t_sub, t_subbed, ctx):
    return {"sched": sched, "submit": t_sub, "submitted": t_subbed,
            "ctx": ctx}


def _run_due(hooks, now):
    """Run (and drop) the hooks whose time (absolute) has come."""
    while hooks and hooks[0][0] <= now:
        hooks.pop(0)[1]()


def open_loop(teola, queries, offsets, seconds: float, drain_s: float,
              hooks=()):
    """Send query i at window start + offsets[i]; after the window, wait
    up to ``drain_s`` for the queries still out. ``hooks``: (offset s,
    callable) run on this thread when due (the profiled slice's edges).
    Returns (t0, t_close, t_drained, records)."""
    t0 = time.time()
    hooks = sorted((t0 + off, fn) for off, fn in hooks)
    recs = []
    events = [(t0 + float(off), q) for off, q in zip(offsets, queries)]
    events.append((t0 + seconds, None))
    for due, q in events:
        while True:
            now = time.time()
            _run_due(hooks, now)
            nxt = min([due] + [h[0] for h in hooks[:1]])
            if now >= due:
                break
            time.sleep(max(0.0, nxt - now))
        if q is not None:
            ts = time.time()
            ctx = _submit(teola, q)
            recs.append(_record(due, ts, time.time(), ctx))
    _run_due(hooks, float("inf"))
    t_close = time.time()
    deadline = t_close + drain_s
    for r in recs:
        if r["ctx"].done.wait(max(0.0, deadline - time.time())):
            r.setdefault("seen", time.time())
    return t0, t_close, time.time(), recs


def summarize(recs) -> list:
    """One dict per query of the window: its times, whether it was
    answered, its latency from the scheduled send, its primitives'
    spans."""
    rows = []
    for r in recs:
        ctx = r["ctx"]
        # a query failed by its engine is done without an answer time:
        # it counts when the loop saw it done
        done = (ctx.t_done or r.get("seen")) if ctx.done.is_set() else None
        ok = done is not None and _answered(ctx)
        rows.append({
            "error": None if ctx.error is None else repr(ctx.error)[:300],
            "qid": ctx.qid, "sched": r["sched"], "submit": r["submit"],
            "submitted": r["submitted"], "done": done, "ok": ok,
            "latency_s": None if done is None else done - r["sched"],
            "spans": [(a, b) for a, b in ctx.node_spans.values()
                      if b is not None]})
    return rows


class Slice:
    """In a traced run: torch.profiler over [start, start + length) of
    the window (s from its start), opened and closed by the window's own
    thread (the profiler's hooks); the engine's stats and the kernels'
    calls are read at both edges."""

    def __init__(self, start: float, length: float, core, kernels):
        self.start, self.length = start, length
        self.core, self.kernels = core, kernels
        self.prof = self._mark = None
        self.stats = None

    def hooks(self):
        return [(self.start, self.open),
                (self.start + self.length, self.close)]

    def open(self):
        import torch
        from harness.trace import profiler
        self.prof = profiler()
        self.prof.start()
        self._mark = torch.profiler.record_function("bench.slice")
        self._mark.__enter__()
        self._s0 = dict(self.core.stats)
        self.kernels.on = True

    def close(self):
        import torch
        self.kernels.on = False
        s1 = dict(self.core.stats)
        self._mark.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.stats = {k: s1[k] - self._s0[k] for k in
                      ("prefill_tokens", "decode_tokens")}
