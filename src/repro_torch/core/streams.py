"""Streaming decode channels (decode -> downstream pipelining).

A ``TokenStream`` is the value a streaming decode primitive publishes into
the query object store *while it is still decoding*: an append-only,
thread-safe text channel. Chunks of newly decoded text are ``put`` by the
engine executor as they are produced; the runtime early-releases the
decode's graph children on the first chunk, so a downstream primitive
(rerank, condition, aggregate, ...) is dispatched — and can start
consuming — before sequence completion.

Consumers that need the complete text call ``wait_text()`` (blocks until
``close``); incremental consumers iterate the stream or poll
``snapshot()``. After ``close(final)`` the runtime overwrites the store
key with the plain final string, so late consumers never see the channel
object and the non-streaming store layout is restored byte-for-byte.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional


class TokenStream:
    def __init__(self, key: str = ""):
        self.key = key
        self._text = ""
        self._chunks: List[str] = []       # deltas, in arrival order
        self.chunk_times: List[float] = []  # wall time of each delta
        self._closed = False
        self._cv = threading.Condition()
        # runtime hook: fired exactly once, on the first chunk (or on
        # close if the decode produced everything in one shot). MUST NOT
        # block: it is invoked from the engine executor thread mid-decode.
        self.on_first: Optional[Callable[[], None]] = None
        self._first_fired = False

    # -- producer side ------------------------------------------------------
    def put(self, text_so_far: str):
        """Advance the stream to `text_so_far` (snapshot-replace: engines
        report cumulative decoded text; the delta is recorded as a chunk)."""
        fire = None
        with self._cv:
            if self._closed:
                return
            delta = text_so_far[len(self._text):]
            if not delta:
                return
            self._text = text_so_far
            self._chunks.append(delta)
            self.chunk_times.append(time.time())
            if not self._first_fired:
                self._first_fired = True
                fire = self.on_first
            self._cv.notify_all()
        if fire is not None:
            fire()

    def close(self, final_text: Optional[str] = None):
        fire = None
        with self._cv:
            if self._closed:
                return
            if final_text is not None and final_text != self._text:
                delta = final_text[len(self._text):]
                if delta:
                    self._chunks.append(delta)
                    self.chunk_times.append(time.time())
                self._text = final_text
            self._closed = True
            if not self._first_fired:
                self._first_fired = True
                fire = self.on_first
            self._cv.notify_all()
        if fire is not None:
            fire()

    # -- consumer side ------------------------------------------------------
    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def snapshot(self) -> str:
        """Text decoded so far (non-blocking)."""
        with self._cv:
            return self._text

    def wait_text(self, timeout: float = 300) -> str:
        """Block until the stream closes; return the complete text."""
        with self._cv:
            self._cv.wait_for(lambda: self._closed, timeout)
            return self._text

    def __iter__(self):
        """Yield text deltas as they arrive; terminates at close."""
        i = 0
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: len(self._chunks) > i or self._closed, 300)
                chunks = self._chunks[i:]
                i = len(self._chunks)
                closed = self._closed
            for c in chunks:
                yield c
            if closed and i == len(self._chunks):
                return

    def __repr__(self):
        return (f"<TokenStream {self.key} chunks={len(self._chunks)} "
                f"closed={self._closed}>")


def resolve(value, timeout: float = 300):
    """Collapse a possibly-streaming store value to its final form."""
    if isinstance(value, TokenStream):
        return value.wait_text(timeout)
    return value
