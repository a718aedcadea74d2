"""Primitive executors: resolve a batch of NodeTasks against the per-query
object stores, invoke the engine op, and write outputs back."""
from __future__ import annotations

import inspect
import threading
from typing import List

import numpy as np

from repro_torch.core import primitives as P
from repro_torch.core.streams import TokenStream, resolve


def _textify(v) -> str:
    if v is None:
        return ""
    if isinstance(v, TokenStream):
        # stream-unaware consumer: block until the decode completes
        return v.wait_text()
    if isinstance(v, str):
        return v
    if isinstance(v, dict):
        return v.get("text", str(v))
    if isinstance(v, (list, tuple)):
        return " ".join(_textify(x) for x in v)
    return str(v)


def _items(store, prim):
    data = resolve(store[prim.config["items_key"]])
    rng = prim.config.get("item_range")
    if rng:
        data = data[rng[0]:rng[1]]
    return data


def _out_key(prim):
    # primary produced key (excluding state keys and per-slot keys)
    cands = [k for k in prim.produces if not k.startswith("state:")]
    plain = [k for k in cands if "#" not in k]
    if plain:
        return plain[0]
    return cands[0] if cands else next(iter(prim.produces))


def _write_slots(store, prim, main_key, result_list):
    """Publish per-slot keys 'main#i' a downstream consumer asked for."""
    for k in prim.produces:
        if k.startswith(main_key + "#") and "#s" not in k:
            i = int(k.rsplit("#", 1)[1])
            if result_list:
                store[k] = [result_list[min(i, len(result_list) - 1)]]
            else:
                store[k] = []


def _sid(prim, ctx, item=None):
    base = f"{ctx.qid}:{prim.config['sid']}" if "sid" in prim.config \
        else f"{ctx.qid}:{prim.pid}"
    sid = base if item is None else f"{base}:{item}"
    ctx.sids.add(sid)
    return sid


def _prompt_text(prim, store) -> str:
    pieces = []
    for name, key in prim.config.get("parts", []):
        if key is None:
            pieces.append(prim.config.get("instruction", ""))
        else:
            pieces.append(_textify(store.get(key)))
    return " ".join(x for x in pieces if x)


def _overload_plan(prim, ctx):
    """Degradation overrides for one primitive of one query — None on
    every off path (no overload manager / degradation disabled / ladder
    at level 0 / no annotation), which keeps execution token-identical.
    Cached per (query, pid): the brown-out ladder may move between
    calls, but one primitive must see ONE consistent decision."""
    ov = getattr(ctx, "overload", None)
    if ov is None:
        return None
    plans = getattr(ctx, "_ov_plans", None)
    if plans is None:
        plans = ctx._ov_plans = {}
    if prim.pid not in plans:
        plans[prim.pid] = ov.degrade_plan(prim, ctx)
    return plans[prim.pid]


def _degraded_max_new(prim, ctx, default: int) -> int:
    plan = _overload_plan(prim, ctx)
    if plan and "max_new" in plan:
        return plan["max_new"]
    return default


def _degraded_top_k(prim, ctx, default: int) -> int:
    plan = _overload_plan(prim, ctx)
    if plan and "top_k" in plan:
        return plan["top_k"]
    return default


def decode_entries(prim, ctx) -> List[tuple]:
    """(sid, max_new) per sequence of one decode task — shared by the
    loop dispatch below and the scheduler's disaggregated handoff (which
    must enumerate exactly the sids ``submit_decode_task`` will submit,
    to migrate them first)."""
    entries = []
    if prim.config.get("per_item_seq"):
        rng = prim.config.get("item_range")
        lo = rng[0] if rng else 0
        mn = _degraded_max_new(prim, ctx, prim.config.get("max_new", 12))
        for i in range(prim.num_requests):
            entries.append((_sid(prim, ctx, lo + i), mn))
    else:
        entries.append((_sid(prim, ctx),
                        _degraded_max_new(prim, ctx,
                                          prim.config.get("max_new", 24))))
    return entries


def _prefill_payload(prim, ctx) -> List[dict]:
    """Per-sequence prefill payload dicts for one task — shared by the
    batch executor and the chunked-loop dispatch so the sid/text
    construction can never diverge between the two paths."""
    store = ctx.store
    if prim.config.get("per_item_seq"):
        rng = prim.config.get("item_range", (0, 0))
        return [{"sid": _sid(prim, ctx, rng[0] + i),
                 "text": (prim.config.get("instruction", "") + " "
                          + _textify(it_))}
                for i, it_ in enumerate(_items(store, prim))]
    return [{"sid": _sid(prim, ctx), "text": _prompt_text(prim, store)}]


def _slo_tag(task, engine):
    """SLO tag for one task's sequences — built only when the routed
    engine has an armed policy (``engine.slo``), so flag-off call sites
    are byte-identical (no extra kwarg reaches the engine). The tag
    carries the query's SLO class / legacy priority / tenant plus the
    PRIMITIVE's e-graph depth: a deep decode has more downstream work
    hanging off it, so it ranks ahead of a shallow one of the same
    class (critical-path slack from ``depth()``)."""
    if getattr(engine, "slo", None) is None:
        return None
    from repro_torch.serving.slo import derive_tag
    ctx = task.ctx
    return derive_tag(slo=getattr(ctx, "slo", None),
                      priority=getattr(ctx, "priority", 0),
                      tenant=getattr(ctx, "tenant", "default"),
                      depth=task.prim.depth,
                      t_submit=ctx.t_submit,
                      deadline=getattr(ctx, "deadline", None))


def rebuild_full_prompt(engine_name: str, ctx, sid: str):
    """Reconstruct a sequence's WHOLE prompt from the query e-graph. A
    prompt split by the causal-prefill pass lives in two primitives —
    PartialPrefilling (early parts) + FullPrefilling (late parts) — so
    every matching piece is collected and joined in causal order; the
    whitespace tokenizer guarantees ``encode(a) + encode(b) ==
    encode(a + " " + b)``, making the joined replay token-identical to
    the split original. Returns None when no prefill primitive of this
    engine produced the sequence."""
    pieces = {}                             # op -> payload text
    for prim in ctx.graph.nodes.values():
        if prim.op not in (P.PREFILL, P.PARTIAL_PREFILL, P.FULL_PREFILL):
            continue
        if prim.engine != engine_name:
            continue
        try:
            for p in _prefill_payload(prim, ctx):
                if p["sid"] == sid:
                    pieces[prim.op] = p["text"]
        except Exception:  # noqa: BLE001 — unresolved sibling payloads
            continue
    if not pieces:
        return None
    order = (P.PREFILL, P.PARTIAL_PREFILL, P.FULL_PREFILL)
    return " ".join(pieces[o] for o in order if o in pieces and pieces[o])


def _continuation_payload(prim, ctx, engine, items):
    """A FullPrefilling continuation rerouted off a dead replica: the
    partial state it would extend died with that replica, so prefill the
    WHOLE rebuilt prompt (early + late parts) on the fresh state —
    silently prefilling only the late parts would decode from a wrong
    prefix. No-op (and allocation-free) on the healthy path, where the
    partial state is resident on the routed engine."""
    if not prim.config.get("continue_partial"):
        return items
    states = getattr(engine, "states", {})
    out = []
    for p in items:
        if p["sid"] not in states:
            full = rebuild_full_prompt(prim.engine, ctx, p["sid"])
            if full is not None:
                p = {**p, "text": full}
        out.append(p)
    return out


# ---------------------------------------------------------------------------

def execute_batch(engine, tasks: List):
    op = tasks[0].prim.op
    kind = getattr(engine, "kind", "")
    if op == P.CHUNKING:
        payload = [{"docs": t.ctx.store["docs"],
                    "chunk_size": t.prim.config.get("chunk_size", 48),
                    "overlap": t.prim.config.get("overlap", 8)}
                   for t in tasks]
        res = engine.op_chunk(payload)
        for t, r in zip(tasks, res):
            t.ctx.store[_out_key(t.prim)] = r
        return

    if op == P.EMBEDDING:
        payload = []
        for t in tasks:
            items = _items(t.ctx.store, t.prim)
            if isinstance(items, (str, dict)):
                items = [items]
            payload.append({"texts": [_textify(x) for x in items],
                            "_items": items})
        res = engine.op_embed(payload)
        for t, r, pl in zip(tasks, res, payload):
            t.ctx.store[_out_key(t.prim)] = {
                "vectors": r, "meta": [x if isinstance(x, dict)
                                       else {"text": _textify(x)}
                                       for x in pl["_items"]]}
        return

    if op == P.INGESTION:
        payload = []
        for t in tasks:
            src = t.ctx.store[next(iter(t.prim.consumes))]
            payload.append({"collection": t.ctx.qid,
                            "vectors": src["vectors"], "meta": src["meta"]})
        engine.op_ingest(payload)
        for t in tasks:
            t.ctx.store[_out_key(t.prim)] = True
        return

    if op == P.SEARCHING:
        payload, spans = [], []
        for t in tasks:
            qsrc = t.ctx.store[t.prim.config["items_key"]
                               if t.prim.config.get("items_key") in
                               t.ctx.store else
                               next(k for k in t.prim.consumes
                                    if k.startswith("query_vecs"))]
            vecs = qsrc["vectors"] if isinstance(qsrc, dict) else qsrc
            vecs = np.atleast_2d(np.asarray(vecs))
            spans.append((len(payload), len(payload) + len(vecs)))
            top_k = _degraded_top_k(t.prim, t.ctx,
                                    t.prim.config.get("top_k", 3))
            for v in vecs:
                payload.append({"collection": t.ctx.qid, "query_vec": v,
                                "top_k": top_k})
        res = engine.op_search(payload)
        for t, (a, b) in zip(tasks, spans):
            hits = [h for r in res[a:b] for h in r]
            main = _out_key(t.prim)
            t.ctx.store[main] = hits
            _write_slots(t.ctx.store, t.prim, main, hits)
        return

    if op == P.RERANKING:
        payload, ranked = [], []
        for t in tasks:
            cands = []
            for k in t.prim.consumes:
                if k.startswith("retrieved"):
                    cands.extend(t.ctx.store.get(k) or [])
            # dedup by text
            seen, uniq = set(), []
            for c in cands:
                if c["text"] not in seen:
                    seen.add(c["text"])
                    uniq.append(c)
            plan = _overload_plan(t.prim, t.ctx) or {}
            top_k = plan.get("top_k", t.prim.config.get("top_k", 3))
            if plan.get("skip"):
                # degraded passthrough: forward the first top_k deduped
                # candidates unscored — graph shape and store layout are
                # preserved, only the scoring pass is shed
                r = uniq[:top_k]
                main = _out_key(t.prim)
                t.ctx.store[main] = r
                _write_slots(t.ctx.store, t.prim, main, r)
                continue
            ranked.append(t)
            payload.append({"question": t.ctx.store.get("question", ""),
                            "candidates": uniq,
                            "top_k": top_k})
        res = engine.op_rerank(payload) if payload else []
        for t, r in zip(ranked, res):
            main = _out_key(t.prim)
            t.ctx.store[main] = r
            _write_slots(t.ctx.store, t.prim, main, r)
        return

    if op == P.SEARCH_API:
        payload = [{"question": t.ctx.store.get("question", ""),
                    "top_k": t.prim.config.get("top_k", 4)}
                   for t in tasks
                   if t.ctx.store.get("need_search", True)]
        res = engine.op_search(payload) if payload else []
        it = iter(res)
        for t in tasks:
            if t.ctx.store.get("need_search", True):
                t.ctx.store[_out_key(t.prim)] = next(it)
            else:
                t.ctx.store[_out_key(t.prim)] = []
        return

    if op in (P.PREFILL, P.PARTIAL_PREFILL, P.FULL_PREFILL):
        payload = []
        for t in tasks:
            items = _prefill_payload(t.prim, t.ctx)
            payload.extend(_continuation_payload(t.prim, t.ctx, engine,
                                                 items))
        engine.op_prefill(payload)
        for t in tasks:
            for k in t.prim.produces:
                t.ctx.store[k] = True
        return

    if op in (P.DECODE, P.PARTIAL_DECODE):
        payload, spans = [], []
        slot_streams = {}       # payload slot -> TokenStream
        for t in tasks:
            prim, store = t.prim, t.ctx.store
            if prim.config.get("per_item_seq"):
                # items decoded on their own sequences (contextualize)
                src_prefill_range = prim.config.get("item_range")
                n_items = prim.num_requests
                lo = src_prefill_range[0] if src_prefill_range else 0
                spans.append((len(payload), len(payload) + n_items))
                mn = _degraded_max_new(prim, t.ctx,
                                       prim.config.get("max_new", 12))
                for i in range(n_items):
                    payload.append({"sid": _sid(prim, t.ctx, lo + i),
                                    "max_new": mn})
            else:
                spans.append((len(payload), len(payload) + 1))
                payload.append({"sid": _sid(prim, t.ctx),
                                "max_new": _degraded_max_new(
                                    prim, t.ctx,
                                    prim.config.get("max_new", 24))})
                if t.stream is not None:
                    slot_streams[len(payload) - 1] = t.stream
        if slot_streams and "on_chunk" in inspect.signature(
                engine.op_decode).parameters:
            def on_chunk(i, text_so_far):
                s = slot_streams.get(i)
                if s is not None:
                    s.put(text_so_far)
            res = engine.op_decode(payload, on_chunk=on_chunk)
        else:
            res = engine.op_decode(payload)
        for t, (a, b) in zip(tasks, spans):
            _write_decode_outputs(t, res[a:b])
        return

    raise ValueError(f"no executor for op {op} on engine kind {kind}")


def _write_decode_outputs(t, texts: List[str]):
    """Publish a decode task's final texts into the query store (shared by
    the batch executor and the continuous-batching submit path)."""
    prim, store = t.prim, t.ctx.store
    key = prim.config.get("out_key", _out_key(prim))
    if prim.config.get("per_item_seq"):
        store[key] = [{"text": x} for x in texts]
    elif prim.op == P.DECODE and prim.config.get("num_items", 1) > 1:
        # unsplit decode of a multi-item output: divide evenly
        words = texts[0].split()
        k = prim.config["num_items"]
        per = max(1, len(words) // k)
        store[key] = [" ".join(words[i * per:(i + 1) * per])
                      for i in range(k)]
    else:
        if t.stream is not None:
            # seal the channel, then restore the plain-text store
            # layout (late consumers never see the stream object)
            t.stream.close(texts[0])
        store[key] = texts[0]
    if prim.config.get("also_aggregate"):
        agg = prim.config["also_aggregate"]
        parts = [store.get(f"{agg}#{i}", "")
                 for i in range(prim.config.get("num_items", 1))]
        store[agg] = [p for p in parts]
    for k2 in prim.produces:
        if k2.startswith("state:"):
            store[k2] = True


def submit_prefill_task(engine, task, done, on_fail=None, ft=None):
    """Chunked-prefill dispatch of ONE prefill NodeTask: every sequence
    of the task is queued into the engine's continuous loop as a
    resumable PrefillJob (``submit_prefill``) — the loop lands
    budget-bounded chunks BETWEEN decode iterations instead of running
    one monolithic whole-prompt forward that would head-of-line-block
    every co-resident decode. The scheduler thread returns immediately;
    when the task's LAST job completes, the store is written exactly as
    the batch executor writes it and ``done(task)`` fires on the loop
    thread. On a job error the query is failed like ``_fail_batch`` and
    ``on_fail(task)``, if given, runs cleanup.

    ``ft`` (optional) is a ``faults.TaskRecovery`` handle: a failed job
    is offered for recovery (resubmission on a healthy replica) before
    being counted as a failure, duplicate completions of a recovered
    job are dropped, and terminal errors are wrapped structurally."""
    prim, ctx = task.prim, task.ctx
    store = ctx.store
    payload = _prefill_payload(prim, ctx)

    if not payload:                      # zero-item prefill: parity with
        for k in prim.produces:          # the batch path's empty span
            store[k] = True
        if ft is not None:
            ft.settle()
        done(task)
        return

    lock = threading.Lock()
    remaining = [len(payload)]
    errors: List = []
    completed = [False] * len(payload)

    def fail(err):
        if ft is not None:
            err = ft.wrap(err)
        if task.stream is not None:
            task.stream.close()
        if ctx.error is None:    # first error wins (root cause)
            ctx.error = err
        ctx.done.set()
        if on_fail is not None:
            on_fail(task)
        if ft is not None:
            ft.settle()

    def job_done(j, job):
        if ft is not None and ft.cancelled:
            return                       # deadline already failed the task
        with lock:
            if completed[j]:
                return                   # duplicate (job was recovered)
        if job.error is not None and ft is not None and ft.recover(j, job):
            return                       # retry scheduled elsewhere
        with lock:
            if completed[j]:
                return
            completed[j] = True
            if job.error is not None:
                errors.append(job.error)
            remaining[0] -= 1
            last = remaining[0] == 0
        if ft is not None:
            ft.note_done(j)
        if not last:
            return
        if errors:
            fail(errors[0])
            return
        try:
            for k in prim.produces:
                store[k] = True
        except Exception as e:  # noqa: BLE001
            fail(e)
            return
        if ft is not None:
            ft.settle()
        done(task)

    def _submit(j, eng, prev):
        p = _continuation_payload(prim, ctx, eng, [payload[j]])[0]
        tag = _slo_tag(task, eng)
        if tag is not None:
            p = {**p, "slo": tag}
        job = eng.submit_prefill(p,
                                 on_done=lambda job, j=j: job_done(j, job))
        plan = _overload_plan(prim, ctx)
        if plan and plan.get("chunk_cap"):
            # degraded mode: the loop lands smaller chunks for this job
            # (best-effort — a chunk already taken stays at full size)
            job.chunk_cap = int(plan["chunk_cap"])
        if ft is not None:
            ft.note_submitted(j, job)

    if ft is not None:
        ft.bind([p["sid"] for p in payload], _submit, fail)
    for j in range(len(payload)):
        try:
            _submit(j, engine, None)
        except Exception as e:  # noqa: BLE001 — count the failed job so
            if ft is not None and ft.recover_submit(j, e):
                continue        # replay scheduled on a healthy replica
            with lock:          # the task still completes (as a failure)
                completed[j] = True
                errors.append(e)
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                fail(errors[0])


def submit_decode_task(engine, task, done, on_fail=None, ft=None):
    """Continuous-batching dispatch of ONE decode NodeTask: every sequence
    of the task is admitted into the engine's persistent decode loop
    (``submit_decode``) instead of a blocking run-to-completion batch. The
    scheduler thread returns immediately; when the task's LAST sequence is
    evicted from the loop, the store is written exactly as the batch path
    writes it and ``done(task)`` fires on the loop thread. On a sequence
    error the query is failed like ``_fail_batch`` (done is NOT called)
    and ``on_fail(task)``, if given, runs cleanup (e.g. releasing the
    pool's in-flight ledger).

    ``ft`` (optional) is a ``faults.TaskRecovery`` handle. With it, a
    failed sequence is offered for recovery before being counted: the
    handle resubmits on a healthy replica through ``recover_decode``
    (prompt replayed from the e-graph, emitted tokens teacher-forced —
    token-identical resume). A sequence routed to an engine that does
    not hold its state (its pinned replica died between prefill and
    decode) takes the same replay path. Duplicate completions — a hung
    replica finishing a sequence that was already recovered elsewhere —
    are dropped, and terminal errors are wrapped structurally."""
    prim, ctx = task.prim, task.ctx
    entries = decode_entries(prim, ctx)  # (sid, max_new) per sequence

    if not entries:                      # zero-item decode: parity with
        _write_decode_outputs(task, [])  # the batch path's empty span
        if ft is not None:
            ft.settle()
        done(task)
        return

    lock = threading.Lock()
    remaining = [len(entries)]
    results: List = [None] * len(entries)
    errors: List = []
    completed = [False] * len(entries)

    def fail(err):
        if ft is not None:
            err = ft.wrap(err)
        if task.stream is not None:
            task.stream.close()
        if ctx.error is None:    # first error wins (root cause)
            ctx.error = err
        ctx.done.set()
        if on_fail is not None:
            on_fail(task)
        if ft is not None:
            ft.settle()

    def finish():
        if errors:
            fail(errors[0])
            return
        try:
            _write_decode_outputs(task, results)
        except Exception as e:  # noqa: BLE001
            fail(e)
            return
        if ft is not None:
            ft.settle()
        done(task)

    def seq_done(j, seq):
        if ft is not None and ft.cancelled:
            return                       # deadline already failed the task
        with lock:
            if completed[j]:
                return                   # duplicate (seq was recovered)
        if seq.error is not None and ft is not None and ft.recover(j, seq):
            return                       # retry scheduled elsewhere
        with lock:
            if completed[j]:
                return
            completed[j] = True
            if seq.error is not None:
                errors.append(seq.error)
            results[j] = seq.result
            remaining[0] -= 1
            last = remaining[0] == 0
        if ft is not None:
            ft.note_done(j)
        if last:
            # a completion-path failure (done -> graph bookkeeping) must
            # fail the query, not strand it; the ledger was already
            # released by done's own wrapper at that point
            try:
                finish()
            except Exception as e:  # noqa: BLE001
                if task.stream is not None:
                    task.stream.close()
                if ctx.error is None:
                    ctx.error = e
                ctx.done.set()

    on_text = task.stream.put if (task.stream is not None
                                  and len(entries) == 1) else None

    def _submit(j, eng, prev):
        sid, max_new = entries[j]
        cb = lambda seq, j=j: seq_done(j, seq)   # noqa: E731
        tag = _slo_tag(task, eng)
        extra = {} if tag is None else {"slo": tag}
        if ft is not None and (prev is not None or
                               sid not in getattr(eng, "states", {})):
            seq = eng.recover_decode(sid, ft.prompt_for(sid), max_new,
                                     prev, on_text=on_text, on_done=cb,
                                     **extra)
        else:
            seq = eng.submit_decode(sid, max_new, on_text=on_text,
                                    on_done=cb, **extra)
        if ft is not None:
            ft.note_submitted(j, seq)

    if ft is not None:
        ft.bind([sid for sid, _ in entries], _submit, fail)
    for j in range(len(entries)):
        try:
            _submit(j, engine, None)
        except Exception as e:  # noqa: BLE001 — admission failed (e.g.
            if ft is None:      # the routed replica just died): offer
                raise           # recovery before failing the task
            if not ft.recover_submit(j, e):
                fail(e)
                return


# ---------------------------------------------------------------------------

def run_control(prim, ctx):
    store = ctx.store
    if prim.op == P.CONDITION:
        pred = prim.config.get("predicate", "always_true")
        if pred == "always_true":
            val = True
        elif pred == "never":
            val = False
        elif callable(pred):
            val = bool(pred(store))
        else:
            val = True
        store[_out_key(prim)] = val
        return
    if prim.op == P.AGGREGATE:
        out = _out_key(prim)
        if "concat_of" in prim.config:
            keys = sorted((k for k in prim.consumes),
                          key=lambda s: int(s.rsplit("#s", 1)[1])
                          if "#s" in s else 0)
            vals = [resolve(store.get(k)) for k in keys]
            if all(isinstance(v, dict) and "vectors" in v for v in vals):
                store[out] = {
                    "vectors": np.concatenate([v["vectors"] for v in vals]),
                    "meta": sum((v["meta"] for v in vals), [])}
            elif all(isinstance(v, list) for v in vals):
                store[out] = sum(vals, [])
            elif all(v is True for v in vals):
                store[out] = True
            else:
                store[out] = vals
        else:
            store[out] = [resolve(store.get(k))
                          for k in sorted(prim.consumes)]
        return
    raise ValueError(f"unknown control op {prim.op}")
