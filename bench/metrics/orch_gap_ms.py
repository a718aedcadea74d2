"""orch_gap_ms: per answered query, the ms from its submit call to its
answer in which none of its primitives was between dispatch and
completion (QueryContext.node_spans): graph building, passes and the
hand-offs between primitives. Mean over the queries."""


def read(run):
    from harness.stats import clip, union_length
    gaps = []
    for q in run["queries"]:
        if not q["ok"]:
            continue
        a, b = q["submit"], q["done"]
        gaps.append((b - a) - union_length(clip(q["spans"], a, b)))
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
