"""The yardstick: the card's published peaks, the bytes and operations
each hand-written kernel call needs (frozen from the port's
``chip_smoke.py``: ``_prefill_work``, ``_decode_work``, ``_paged_work``,
``_scan_work``, ``_bound``), and the model FLOPs of a token.

A call's bytes count each input read once and each output written once:
q in and o out, and the K/V rows its keys need (for the paged kernels the
rows the positions need, whatever blocks the table names). Its operations
are 4 * hd per (query head, key) pair. K6's are ``ops`` per state element
and step: 5 are what the recurrence needs (k*v, then w*S + kv and r*S as
multiply-adds); 7 is how the port's kernel table has counted them.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
# the fastest way to an fp32-accurate product on the card: three bf16
# tensor-core products (the port's K1 and K5 split q and P so), hence the
# rate a kernel's operations are bounded by in a roofline share
TC_FP32_FLOPS = BF16_TC_FLOPS / 3
SCAN_OPS_NEEDED, SCAN_OPS_TABLE = 5, 7


def bound_ms(nbytes: float, flops: float, flops_per_s: float) -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / flops_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def prefill_work(q_shape, q_itemsize, prefix, kv_row_bytes, max_len):
    """K1: q (B, Sq, H, hd) against a dense cache of ``max_len`` slots
    holding each row's ``prefix`` (list) then its Sq new keys."""
    B, Sq, nh, hd = q_shape
    kv_rows = sum(min(max_len, p + Sq) for p in prefix)
    nbytes = B * Sq * nh * hd * q_itemsize * 2 + kv_rows * kv_row_bytes
    keys = sum(p * Sq + Sq * (Sq + 1) // 2 for p in prefix)
    return nbytes, 4 * hd * nh * keys


def decode_work(q_shape, q_itemsize, lengths, kv_row_bytes, max_len):
    """K2: q (B, H, hd), each row reading its ``lengths`` keys."""
    B, nh, hd = q_shape
    kv_rows = sum(min(max_len, n) for n in lengths)
    nbytes = B * nh * hd * q_itemsize * 2 + kv_rows * kv_row_bytes
    return nbytes, 4 * hd * nh * kv_rows


def paged_work(q_shape, q_itemsize, qpos_rows, kv_row_bytes):
    """K3, K4, K5: ``qpos_rows`` is each row's list of absolute query
    positions; a query at position p reads keys 0..p."""
    nh, hd = q_shape[-2:]
    nq = 1
    for s in q_shape:
        nq *= s
    rows = sum(max(r) + 1 for r in qpos_rows)
    pairs = sum(p + 1 for r in qpos_rows for p in r)
    return nq * q_itemsize * 2 + rows * kv_row_bytes, 4 * hd * nh * pairs


def scan_work(shape, itemsize, ops: int = SCAN_OPS_NEEDED):
    """K6: r, k, v, w (B, S, H, hd) in, y out (fp32), the (B, H, hd, hd)
    fp32 state in and out."""
    B, S, H, hd = shape
    n = B * S * H * hd
    nbytes = 4 * n * itemsize + n * 4 + 2 * B * H * hd * hd * 4
    return nbytes, ops * hd * hd * B * S * H


def token_flops(conf: dict) -> dict:
    """Model FLOPs of one token from a configuration file's sizes: "body"
    (every layer's products, the MoE's router, its top-k routed experts
    and its shared experts; RWKV-6's recurrence at the operations it
    needs) and "head" (the LM head, paid where logits are taken).
    Attention's query-key work depends on the positions: the kernels'
    calls count it (``prefill_work`` and the others)."""
    d, L, V = conf["hidden_size"], conf["num_hidden_layers"], \
        conf["vocab_size"]
    arch = conf["architecture"]
    if arch == "qwen2_moe":
        H, K, hd = conf["num_attention_heads"], \
            conf["num_key_value_heads"], conf["head_dim"]
        attn = d * (H + 2 * K) * hd + H * hd * d
        moe = (d * conf["num_experts"]
               + conf["num_experts_per_tok"] * 3 * d
               * conf["moe_intermediate_size"]
               + 3 * d * conf["shared_expert_intermediate_size"])
        return {"body": 2 * L * (attn + moe), "head": 2 * d * V}
    if arch == "rwkv6":
        hd, r, f = conf["head_size"], conf["lora_rank"], \
            conf["intermediate_size"]
        H = d // hd
        tm = d * 5 * r + 5 * r * d + 5 * d * d + d * r + r * d
        cm = 2 * d * f + d * d
        scan = SCAN_OPS_NEEDED * H * hd * hd / 2     # counted as products
        return {"body": 2 * L * (tm + cm + scan), "head": 2 * d * V}
    raise ValueError(f"no FLOP count for architecture {arch!r}")


def roofline_share(run, owners) -> float | None:
    """A kernel family's share (%) of its roofline in a run's profiled
    slice: the sum over its calls of each call's bound (bytes at 3.35
    TB/s or operations at TC_FP32_FLOPS, the larger) over the device time
    the profiler charges to the family's kernels; None with nothing to
    read."""
    sl = run["slice"]
    if sl is None:
        return None
    dev = sum(sl["owner_device_s"].get(o, 0.0) for o in owners)
    calls = [w for o in owners for w in sl["bounds"].get(o, ())]
    if dev <= 0 or not calls:
        return None
    need = sum(bound_ms(b, f, TC_FP32_FLOPS)[0] for b, f in calls) / 1e3
    return 100.0 * need / dev
