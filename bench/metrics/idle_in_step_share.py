"""idle_in_step_share: the share (%) of the profiled slice's device idle
time that falls inside a core-LLM ``llm.step`` span: the card waiting on
the host's launches within a decode step. The rest is the card with
nothing queued."""


def read(run):
    from harness.program import (complement, core_steps, device_slice,
                                 merged, overlap, records)
    recs, dev = records(run), device_slice(run)
    if recs is None or dev is None:
        return None
    t0, t1, busy = dev
    idle = complement(busy, t0, t1)
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    steps = merged([(st["start"], st["end"]) for st, _ in core_steps(recs)])
    return 100.0 * overlap(idle, steps) / total
