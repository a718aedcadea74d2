"""decode_host_ms: the host's ms per decode step of the core LLM: each
``llm.step`` span less its ``readback`` spans (the host waiting for the
card), over the steps that lie wholly outside the profiled slice."""


def read(run):
    from harness.program import core_steps, outside, records, slice_edges
    recs = records(run)
    if recs is None:
        return None
    edges = slice_edges(run)
    host = [(st["end"] - st["start"]) -
            sum(c["end"] - c["start"] for c in below
                if c["name"] == "readback")
            for st, below in core_steps(recs) if outside(st, edges)]
    return 1e3 * sum(host) / len(host) if host else None
