"""attn_roofline: K1-K5 (the hand-written attention kernels) together,
their share of their roofline in the profiled slice."""
from harness.work import roofline_share

OWNERS = ("flash_prefill", "decode_attention", "paged_decode_attention",
          "verify_attention", "chunk_prefill_attention")


def read(run):
    return roofline_share(run, OWNERS)
