"""queue_wait_ms: per answered query, the ms from its submit call to its
answer in which some primitive of it waited in its engine's queue
(``prim.wait``: dispatch to the start of the batch that held it) and none
of its primitives ran (``prim.run``). Mean over the queries. With
``orch_gap_ms`` and the time its primitives ran, it makes up the
latency. Host spans of the program, read over the whole window."""


def read(run):
    from harness.program import records
    from harness.stats import clip, union_length
    recs = records(run)
    if recs is None:
        return None
    spans = {}
    for r in recs:
        if r["name"] in ("prim.wait", "prim.run"):
            spans.setdefault((r["qid"], r["name"]), []).append(
                (r["start"], r["end"]))
    waits = []
    for q in run["queries"]:
        if not q["ok"] or (q["qid"], "prim.wait") not in spans:
            continue
        a, b = q["submit"], q["done"]
        w = clip(spans[(q["qid"], "prim.wait")], a, b)
        r = clip(spans.get((q["qid"], "prim.run"), []), a, b)
        waits.append(union_length(w + r) - union_length(r))
    return 1e3 * sum(waits) / len(waits) if waits else None
