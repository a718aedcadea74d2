"""Device records of a profiled slice: who launched each kernel, how busy
the card was, and where it sat idle.

``kernel_owner`` and the reading of raw records are copied from the
port's ``chip_smoke.py`` (``kernel_owner``, ``_device_records``): raw
kineto records, because torch.profiler's Python event tree costs ~0.2 ms
per record.
"""
from __future__ import annotations

from harness.stats import union_length

# the wrapper that launches each hand-written kernel: K2-K4 are templates
# of csrc/split_kv.cuh and K1 / K5 of csrc/flash_tile.cuh, told apart by
# their addressing policy; the others are <name>_kernel in an anonymous
# namespace of their source (the fp32-K/V bodies of K1 and K5 in a
# nested one)
_ANON_KERNELS = (("fp32kv::flash_prefill_fp32kv_kernel<", "flash_prefill"),
                 ("fp32kv::chunk_prefill_fp32kv_kernel<",
                  "chunk_prefill_attention"),
                 ("rwkv6_scan_kernel<", "rwkv6_scan"),
                 ("rwkv6_scan_bwd_kernel<", "rwkv6_scan_bwd"),
                 ("rwkv6_decode_kernel<", "rwkv6_scan"))
_TEMPLATE_KEYS = {
    "void teola::split_kv_": (("teola::DenseKeys", "decode_attention"),
                              ("teola::PagedKeys", "verify_attention"),
                              ("teola::PagedDecodeKeys",
                               "paged_decode_attention")),
    "void teola::ft::flash_tile_kernel<": (
        ("teola::DenseKeys", "flash_prefill"),
        ("teola::ChunkPagedKeys", "chunk_prefill_attention"))}


def kernel_owner(key: str):
    """The kernel wrapper whose C entry point launches the kernel the
    profiler names ``key``, or None for any other kernel."""
    for prefix, policies in _TEMPLATE_KEYS.items():
        if key.startswith(prefix):
            for policy, owner in policies:
                if policy in key:
                    return owner
            return None
    for name, owner in _ANON_KERNELS:
        if key.startswith("void (anonymous namespace)::" + name):
            return owner
    return None


def short_name(key: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    k = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    k = k.split(">(")[0] + ">" if ">(" in k else k.split("(")[0]
    return k[:120]


def device_records(prof) -> list:
    """(name, start s, end s) of each device-side record (kernels, copies,
    fills) of a finished torch.profiler profile, in start order."""
    from torch.autograd import DeviceType
    recs = [(e.name(), e.start_ns() / 1e9,
             (e.start_ns() + e.duration_ns()) / 1e9)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]
    return sorted(recs, key=lambda r: r[1])


def profiler():
    """A torch.profiler session over the card (CPU activity for the thread
    that starts it); ``start()`` and ``stop()`` it on one thread, then read
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def summarize(recs, t0: float, t1: float) -> dict:
    """Busy seconds (union of the records' intervals clipped to the
    device clock's [t0, t1]), the top device operations and the longest
    idle gaps, each gap named after the kernel that ended before it."""
    clipped = [(max(s, t0), min(e, t1), n) for n, s, e in recs
               if e > t0 and s < t1]
    busy = union_length([(s, e) for s, e, _ in clipped])
    by_name = {}
    for s, e, n in clipped:
        k = short_name(n)
        by_name[k] = by_name.get(k, 0.0) + (e - s)
    gaps, end, last = {}, t0, "slice start"
    for s, e, n in sorted(clipped):
        if s > end:
            key = f"after {last}"
            gaps[key] = gaps.get(key, 0.0) + (s - end)
        if e >= end:
            end, last = e, short_name(n)
    if t1 > end:
        gaps[f"after {last}"] = gaps.get(f"after {last}", 0.0) + (t1 - end)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
