"""Spans of the port's layers, kept in memory.

A span is one interval of host work at a layer boundary: its name, its
start and end (``time.time_ns()``, the clock torch.profiler stamps its
host annotations with, so spans and a profile's device records share one
timeline), the thread it ran on, its own id, the id of the span that
caused it, and a few attributes (``qid``, ``pid``, ``engine``, ``op``,
``rows``, ``batch``, ...). Counts ride on spans: as attributes, or as the
number of spans of one name (each ``readback`` is one device-to-host
sync).

Tracing is off until ``enable()``; a reader takes the records with
``drain()``. Off, ``span()`` returns one shared no-op after one flag test
and ``start()`` returns None: no record, no clock reading, no
allocation. On, the records go to a bounded buffer; what arrives past its
capacity is counted in ``dropped`` and lost.

The tracer is one per process (``TRACER``): the spans are opened deep in
the model and the engines, which take no tracer argument. Parents come
from a per-thread stack of open spans; a span whose edges are known only
after the fact (a primitive's wait in its scheduler's queue) is written
with ``record`` and explicit times and parent.

The spans, and the readers they are for (PERF.md section 3):

    query         Runtime.submit to _finish
    prim.wait     a primitive's dispatch to the start of its batch
    prim.run      the start of its batch to its completion
    batch         one executor call of the lower tier (rows, qids)
    llm.prefill   LLMEngine's prefill forward (stacking, padding, steps)
    llm.decode    a run-to-completion decode batch
    llm.step      one decode step (also one continuous-loop iteration)
    moe.dispatch  models/moe.py::routed, router product to combine (path)
    readback      one device-to-host read on the serving path
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

CAPACITY = 1 << 20


class _NoSpan:
    """The shared span of the off path: enters and exits, records
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NOOP = _NoSpan()


class Span:
    """An open span; ``end()`` (or leaving its ``with``) records it."""
    __slots__ = ("tracer", "name", "id", "parent", "start", "attrs")

    def __init__(self, tracer, name, attrs):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.id = next(tracer._ids)
        stack = tracer._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start = time.time_ns()

    def end(self, **attrs):
        t1 = time.time_ns()
        self.tracer._stack().pop()     # spans end in the order they nest
        self.attrs.update(attrs)
        self.tracer.record(self.name, self.start, t1, id=self.id,
                           parent=self.parent, **self.attrs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return None


class Tracer:
    """The records of the spans ended while ``on``, up to ``capacity``."""

    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self.capacity = capacity
        self.dropped = 0
        self._records: list = []
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def new_id(self) -> Optional[int]:
        """An id for a span written later with ``record`` (None when
        off)."""
        return next(self._ids) if self.on else None

    def record(self, name: str, start_ns: int, end_ns: int,
               id: Optional[int] = None, parent: Optional[int] = None,
               **attrs):
        """Write one span with explicit edges (``time.time_ns()``)."""
        if not self.on:
            return
        rec = {"name": name, "start": int(start_ns), "end": int(end_ns),
               "thread": threading.get_ident(),
               "id": next(self._ids) if id is None else id,
               "parent": parent, **attrs}
        with self._lock:
            if len(self._records) < self.capacity:
                self._records.append(rec)
            else:
                self.dropped += 1

    def drain(self) -> dict:
        """{"records": every record since the last drain, in the order
        they ended, "dropped": how many did not fit}; empties the
        buffer."""
        with self._lock:
            out = {"records": self._records, "dropped": self.dropped}
            self._records, self.dropped = [], 0
        return out


TRACER = Tracer()


def enable():
    TRACER.on = True


def disable():
    TRACER.on = False


def enabled() -> bool:
    return TRACER.on


def drain() -> dict:
    return TRACER.drain()


def span(name: str, **attrs):
    """``with span(name, **attrs):`` records the block as one span."""
    if not TRACER.on:
        return NOOP
    return Span(TRACER, name, attrs)


def start(name: str) -> Optional[Span]:
    """A span opened now, for sites hit once per layer: None when off
    (the caller ends it with ``end(**attrs)`` if it is not None), so the
    off path is one call and one test."""
    if not TRACER.on:
        return None
    return Span(TRACER, name, {})


def new_id() -> Optional[int]:
    return TRACER.new_id()


def record(name: str, start_ns: int, end_ns: int, **kw):
    TRACER.record(name, start_ns, end_ns, **kw)


def ns(t: float) -> int:
    """A ``time.time()`` reading on the records' clock."""
    return int(t * 1e9)


def readback(fetch):
    """``fetch()``, a call that copies from the device to the host and so
    waits for it (``t.tolist``, ``t.cpu``, ``t.item``), as one
    ``readback`` span: every host sync of the serving path goes through
    here, so the spans count them."""
    if not TRACER.on:
        return fetch()
    with Span(TRACER, "readback", {}):
        return fetch()


BUSY = ("batch", "llm.prefill", "llm.decode", "llm.step")


def busy_seconds(records) -> dict:
    """{engine: seconds}: per engine, the length of the union of its
    ``batch`` spans and of its own ``llm.*`` spans (which also cover a
    continuous loop's work, outside any batch)."""
    by = {}
    for r in records:
        if r["name"] in BUSY and "engine" in r:
            by.setdefault(r["engine"], []).append((r["start"], r["end"]))
    out = {}
    for eng, iv in by.items():
        total, cur_s, cur_e = 0, None, None
        for s, e in sorted(iv):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        out[eng] = total / 1e9
    return out
