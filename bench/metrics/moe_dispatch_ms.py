"""moe_dispatch_ms: the ms per decode step of the core LLM spent in the
MoE layers' dispatch (``models/moe.py::routed``, router product to
combine, its host sync included): the sum of the step's
``moe.dispatch`` spans, over the steps wholly outside the profiled
slice."""


def read(run):
    from harness.program import core_steps, outside, records, slice_edges
    recs = records(run)
    if recs is None:
        return None
    edges = slice_edges(run)
    per = [sum(c["end"] - c["start"] for c in below
               if c["name"] == "moe.dispatch")
           for st, below in core_steps(recs) if outside(st, edges)]
    return 1e3 * sum(per) / len(per) if per else None
