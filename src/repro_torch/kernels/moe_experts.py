"""Grouped routed-expert products of a mixture-of-experts layer: every
selected (token, expert) pair's gated FFN, with the routing read on the
device.

Replaces no Pallas kernel: the reference's MoE (``src/repro/models/
moe.py``) is plain products. The CUDA kernel written for Hopper,
``repro_torch/csrc/moe_experts.cu``, was added because the port's loop over
experts needs the per-expert counts on the host (one device-to-host sync
per layer) and then launches a gather, three products, an activation and a
multiply for every touched expert: at a decode step the card waited on the
host. The kernel reads the routing (``order``, ``offsets``) on the device
and runs a layer's experts in two launches (gate and up, then down),
whatever the routing. That file's header says what bounds it on the H100
(the touched experts' weight bytes) and what its design does about that.

``moe_experts`` launches the kernels for CUDA tensors and runs
``moe_experts_plain`` for CPU tensors: the same per-expert products as the
port's sorted path (``sorted_products``), with the counts taken from
``offsets`` on the CPU, where nothing is read back from a device. There is
no fallback between the two: a CUDA call that cannot launch raises.
``moe_experts.launches`` counts wrapper calls that launched the kernels
(one per call: both kernels together).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.models.common import act_fn

ACT_CODES = {"silu": 0, "gelu": 1, "relu": 2}   # ACT_* in the source

_count_lock = threading.Lock()
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, order, offsets, gates, w_gate, w_up, w_down, h, y, T, d, f, E, k, act,
# dtype, stream
_ARGTYPES = [_P] * 9 + [_I] * 7 + [_P]


def sorted_products(act, x2d, order, counts, gates, w_gate, w_up, w_down,
                    k):
    """The routed experts' outputs (T*k, d), one row per assignment slot
    t*k + j, already gated, from the per-expert ``counts`` on the host:
    the assignments' tokens gathered in ``order``, each touched expert's
    three products on its slice with ``torch.matmul``, gate x output put
    back in slot order. Returns (rows, experts touched)."""
    xs = x2d[order // k]                                 # (T*k, d)
    # the expert weights are unbound once, so that under autograd their
    # gradients are stacked once rather than each expert's index
    # materialising a zero-filled copy of all E
    wg, wu, wd = (w.unbind(0) for w in (w_gate, w_up, w_down))
    parts, lo = [], 0
    for e, n in enumerate(counts):
        if n:
            xe = xs[lo:lo + n]
            parts.append((act(xe @ wg[e]) * (xe @ wu[e])) @ wd[e])
        lo += n
    ys = torch.cat(parts)
    g = gates.reshape(-1)[order].to(ys.dtype)
    return torch.empty_like(ys).index_copy_(0, order, ys * g[:, None]), \
        len(parts)


def moe_experts_plain(x2d, order, offsets, gates, w_gate, w_up, w_down,
                      act: str, k: int):
    """``moe_experts`` in plain PyTorch: ``sorted_products`` with the
    counts read from ``offsets`` on the CPU. On meta tensors (the dry
    run's shape-only pass) only the shape."""
    T, d = x2d.shape
    if x2d.device.type == "meta":
        return torch.empty((T * k, d), dtype=x2d.dtype, device=x2d.device)
    return sorted_products(act_fn(act), x2d, order, offsets.diff().tolist(),
                           gates, w_gate, w_up, w_down, k)[0]


def _check(x2d, order, offsets, gates, w_gate, w_up, w_down, act, k):
    T, d = x2d.shape
    E, _, f = w_gate.shape
    if act not in ACT_CODES:
        raise ValueError(f"moe_experts: act {act!r} not in "
                         f"{sorted(ACT_CODES)}")
    if w_gate.shape != (E, d, f) or w_up.shape != (E, d, f) or \
            w_down.shape != (E, f, d):
        raise ValueError(f"moe_experts: weights {tuple(w_gate.shape)} / "
                         f"{tuple(w_up.shape)} / {tuple(w_down.shape)} do "
                         f"not fit x {tuple(x2d.shape)}")
    if any(w.dtype != x2d.dtype for w in (w_gate, w_up, w_down)):
        raise ValueError("moe_experts: x and the expert weights differ in "
                         "dtype")
    if order.shape != (T * k,) or offsets.shape != (E + 1,) or \
            gates.shape != (T, k) or order.dtype != torch.int64 or \
            offsets.dtype != torch.int64 or gates.dtype != torch.float32:
        raise ValueError("moe_experts: order (T*k,) and offsets (E+1,) "
                         "must be int64, gates (T, k) float32")
    ts = (x2d, order, offsets, gates, w_gate, w_up, w_down)
    if any(t.device != x2d.device for t in ts):
        raise ValueError("moe_experts: tensors on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("moe_experts: the kernel takes contiguous tensors "
                         "only (no copy is made)")


def moe_experts(x2d, order, offsets, gates, w_gate, w_up, w_down,
                act: str, k: int):
    """The routed experts' gated outputs, one row per assignment slot.

    x2d (T, d) float32 or bfloat16; order (T*k,) int64, the assignment
    slots t*k + j sorted by expert, stably; offsets (E+1,) int64, where
    each expert's rows of ``order`` start; gates (T, k) float32; w_gate,
    w_up (E, d, f) and w_down (E, f, d) in x's dtype; ``act`` "silu",
    "gelu" (tanh) or "relu". Returns y (T*k, d) in x's dtype: row t*k + j
    is gates[t, j] times expert idx[t, j]'s FFN of token t. CUDA tensors
    launch the kernels (fp32 sums on CUDA cores, no TF32); CPU tensors run
    ``moe_experts_plain``."""
    if build.plain_device(x2d):
        return moe_experts_plain(x2d, order, offsets, gates, w_gate, w_up,
                                 w_down, act, k)
    if x2d.device.type != "cuda":
        raise ValueError(f"moe_experts: unsupported device {x2d.device}")
    _check(x2d, order, offsets, gates, w_gate, w_up, w_down, act, k)
    T, d = x2d.shape
    E, _, f = w_gate.shape
    h = torch.empty((T * k, f), dtype=torch.float32, device=x2d.device)
    y = torch.empty((T * k, d), dtype=x2d.dtype, device=x2d.device)
    launch = build.load("moe_experts", "moe_experts_launch", _ARGTYPES)
    err = launch(
        x2d.data_ptr(), order.data_ptr(), offsets.data_ptr(),
        gates.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), h.data_ptr(), y.data_ptr(), T, d, f, E, k,
        ACT_CODES[act], build.dtype_code(x2d),
        torch.cuda.current_stream(x2d.device).cuda_stream)
    build.check("moe_experts", err, "moe_experts")
    with _count_lock:       # engines launch from several threads
        moe_experts.launches += 1
    return y


moe_experts.launches = 0
