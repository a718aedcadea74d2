"""The program's own spans (``repro_torch.tracing``) in a traced run, and
what the readers take from them beside the profiled slice's device
records.

A traced run turns the port's tracer on at the window's start
(``start``) and takes its records after the drain (``collect``: a query
writes its primitives' spans as they complete, some in the drain). The
result goes under ``run["program"]``; the slice adds its edges on the
device trace's clock and the union of its device records
(``slice_fields``). Kineto stamps its records on the clock of
``time.time_ns()``, which the spans use, so the two share one timeline.

The rule every reader keeps: a reader of host time reads only spans that
lie wholly outside the slice (the profiler's CPU activity slows the host
inside it); a reader of device time reads only the slice.

The core LLM is the engine the ``batch`` spans name ``core_llm`` (the
port's engine of that name, which the harness builds).
"""
from __future__ import annotations

import bisect

CORE = "core_llm"
DECODE_OPS = ("Decoding", "PartialDecoding")
AFTER_THE_FACT = ("query", "prim.wait", "prim.run")


def start() -> bool:
    """Turn the port's tracer on; False where the port has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return False
    tracing.drain()
    tracing.enable()
    return True


def collect():
    """Turn the tracer off and take its records: {"records", "dropped"},
    each record's times in seconds; None where the port has no tracer."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    tracing.disable()
    out = tracing.drain()
    for r in out["records"]:
        r["start"], r["end"] = r["start"] / 1e9, r["end"] / 1e9
    return out


def slice_fields(recs, t0: float, t1: float) -> dict:
    """The slice's edges and the union of its device records (``recs``:
    (name, start s, end s)) as sorted, disjoint intervals."""
    return {"t0": t0, "t1": t1, "busy": merged(
        [(max(s, t0), min(e, t1)) for _, s, e in recs if e > t0 and s < t1])}


def merged(intervals) -> list:
    """Sorted, disjoint intervals covering the same time."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def covered(busy, starts, a: float, b: float) -> float:
    """How much of [a, b] sorted, disjoint ``busy`` covers (``starts``:
    its intervals' starts, for the search)."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    total = 0.0
    while i < len(busy) and busy[i][0] < b:
        lo, hi = max(busy[i][0], a), min(busy[i][1], b)
        if hi > lo:
            total += hi - lo
        i += 1
    return total


def complement(busy, t0: float, t1: float) -> list:
    """The gaps of sorted, disjoint ``busy`` inside [t0, t1]."""
    out, cur = [], t0
    for s, e in busy:
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return out


def records(run):
    """The run's program records, or None."""
    prog = run.get("program")
    return None if prog is None else prog["records"]


def slice_edges(run):
    """(t0, t1) of the slice on the device trace's clock, or None."""
    sl = run.get("slice")
    if sl is None or "t0" not in sl:
        return None
    return sl["t0"], sl["t1"]


def device_slice(run):
    """(t0, t1, busy) of a slice that holds device records, or None (no
    slice, or a profile with no device activity: a run on the CPU)."""
    edges = slice_edges(run)
    if edges is None or not run["slice"]["busy"]:
        return None
    return (*edges, run["slice"]["busy"])


def outside(r, edges) -> bool:
    """The span lies wholly outside the slice (or there is none)."""
    return edges is None or r["end"] <= edges[0] or r["start"] >= edges[1]


def inside(r, edges) -> bool:
    return edges is not None and r["start"] >= edges[0] and \
        r["end"] <= edges[1]


def core_steps(recs) -> list:
    """[(step, [its descendants])] for the core LLM's ``llm.step`` spans:
    those under a core-LLM ``batch`` span or naming the core LLM."""
    by_id = {r["id"]: r for r in recs}
    kids = {}
    for r in recs:
        kids.setdefault(r["parent"], []).append(r)

    def is_core(r):
        while r is not None:
            if r.get("engine") == CORE:
                return True
            r = by_id.get(r["parent"])
        return False

    def below(r):
        out, todo = [], list(kids.get(r["id"], ()))
        while todo:
            c = todo.pop()
            out.append(c)
            todo.extend(kids.get(c["id"], ()))
        return out
    return [(r, below(r)) for r in recs
            if r["name"] == "llm.step" and is_core(r)]


def idle_by_span(run):
    """The slice's idle seconds by what the host was doing, top ten:
    the innermost span open on a core-LLM scheduler thread (``batch``
    named ``batch:<engine>``), else ``batch:<engine>`` of any open batch
    span, else ``no engine call``. None without the program's records
    or the slice's device records."""
    recs, dev = records(run), device_slice(run)
    if recs is None or dev is None:
        return None
    t0, t1, busy = dev
    idle = complement(busy, t0, t1)
    core_threads = {r["thread"] for r in recs
                    if r["name"] == "batch" and r.get("engine") == CORE}
    # spans opened and closed on their thread: not the after-the-fact
    # records (query, prim.*), written by whichever thread completed them
    near = [r for r in recs if r["end"] > t0 and r["start"] < t1
            and r["name"] not in AFTER_THE_FACT]
    core = [r for r in near if r["thread"] in core_threads]
    batches = [r for r in near if r["name"] == "batch"]
    out, i = {}, 0
    for (a, b), label in zip(*_segments(core, batches, t0, t1)):
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            s, e = max(idle[j][0], a), min(idle[j][1], b)
            if e > s:
                out[label] = out.get(label, 0.0) + (e - s)
            j += 1
    top = sorted(out.items(), key=lambda kv: -kv[1])[:10]
    return [[k, v] for k, v in top]


def _label(r) -> str:
    return f"batch:{r.get('engine')}" if r["name"] == "batch" else r["name"]


def _segments(core, batches, t0, t1):
    """Consecutive pieces of [t0, t1] and the label of each: the pieces
    end wherever a span of ``core`` or ``batches`` opens or closes."""
    core_ids = {r["id"] for r in core}
    spans = sorted({r["id"]: r for r in core + batches}.values(),
                   key=lambda r: r["start"])
    events = sorted({t0, t1} | {max(t0, min(t1, x)) for r in spans
                               for x in (r["start"], r["end"])})
    active, k, pieces, labels = [], 0, [], []
    for a, b in zip(events, events[1:]):
        while k < len(spans) and spans[k]["start"] <= a:
            active.append(spans[k])
            k += 1
        active = [r for r in active if r["end"] > a]
        in_core = [r for r in active if r["id"] in core_ids]
        open_b = [r for r in active if r["name"] == "batch"]
        if in_core:
            label = _label(max(in_core, key=lambda r: (r["start"], r["id"])))
        elif open_b:
            label = _label(max(open_b, key=lambda r: (r["start"], r["id"])))
        else:
            label = "no engine call"
        pieces.append((a, b))
        labels.append(label)
    return pieces, labels
