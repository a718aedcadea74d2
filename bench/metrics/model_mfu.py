"""model_mfu: the model FLOPs of the tokens the core LLM prefilled and
decoded in the profiled slice, over the slice's seconds times the card's
fp32 peak (67 TFLOP/s; the port computes in fp32 with TF32 off), in %.
FLOPs: every layer's products per token, the LM head per decoded token,
and the attention kernels' query-key work as their calls' shapes give it
(harness/work.py)."""


def read(run):
    from harness.work import FP32_FLOPS
    sl = run["slice"]
    if sl is None or sl["seconds"] <= 0:
        return None
    f, st = run["flops"], sl["stats"]
    attn = sum(fl for calls in sl["bounds"].values() for _, fl in calls)
    total = f["body"] * (st["prefill_tokens"] + st["decode_tokens"]) + \
        f["head"] * st["decode_tokens"] + attn
    return 100.0 * total / (sl["seconds"] * FP32_FLOPS) if total else None
