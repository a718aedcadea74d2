"""host_syncs_per_step: the device-to-host reads per decode step of the
core LLM: the ``readback`` spans inside its ``llm.step`` spans, over the
steps (one per MoE layer and one for the step's tokens)."""


def read(run):
    from harness.program import core_steps, records
    recs = records(run)
    if recs is None:
        return None
    steps = core_steps(recs)
    if not steps:
        return None
    n = sum(c["name"] == "readback" for _, below in steps for c in below)
    return n / len(steps)
