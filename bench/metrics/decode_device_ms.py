"""decode_device_ms: the card's ms per decode step of the core LLM: for
each ``llm.step`` span wholly inside the profiled slice, the union of the
device records inside it (the step ends in a read of its tokens, so its
kernels end inside it). Mean over those steps."""


def read(run):
    from harness.program import (core_steps, covered, device_slice,
                                 inside, records)
    recs, dev = records(run), device_slice(run)
    if recs is None or dev is None:
        return None
    edges, busy = dev[:2], dev[2]
    starts = [s for s, _ in busy]
    dev = [covered(busy, starts, st["start"], st["end"])
           for st, _ in core_steps(recs) if inside(st, edges)]
    return 1e3 * sum(dev) / len(dev) if dev else None
