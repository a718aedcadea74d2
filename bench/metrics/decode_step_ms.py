"""decode_step_ms: host ms per decode step of the core LLM over the
window: spans around LLMEngine.decode_batch (the run-to-completion path),
divided by the steps each ran. The engine reads each step's tokens back,
so a span holds the step's device work."""


def read(run):
    a, b = run["window"]
    spans = [x for x in run["decode_spans"] if x[0] >= a and x[1] <= b]
    steps = sum(s for _, _, _, s in spans)
    if not steps:
        return None
    return 1e3 * sum(b - a for a, b, _, _ in spans) / steps
