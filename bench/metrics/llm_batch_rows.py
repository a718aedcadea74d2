"""llm_batch_rows: the mean rows (requests) of the core LLM's decode
batches in the window: the ``rows`` of its ``batch`` spans, the batches
Teola's lower tier formed."""


def read(run):
    from harness.program import CORE, DECODE_OPS, records
    recs = records(run)
    if recs is None:
        return None
    a, b = run["window"]
    rows = [r["rows"] for r in recs if r["name"] == "batch"
            and r.get("engine") == CORE and r.get("op") in DECODE_OPS
            and a <= r["start"] <= b]
    return sum(rows) / len(rows) if rows else None
