"""RWKV-6 WKV recurrence (the time-mix scan of every RWKV-6 layer).

Replaces the Pallas TPU kernel ``src/repro/kernels/rwkv6_scan.py::
rwkv6_scan`` (``_kernel``) with a CUDA kernel written for Hopper,
``repro_torch/csrc/rwkv6_scan.cu``. That file's header says what bounds
it on the H100 and what its design does about that.

``rwkv6_scan`` launches the kernel for CUDA tensors and runs
``rwkv6_scan_plain`` — the recurrence of ``repro/kernels/ref.py::
rwkv6_scan_ref`` in plain PyTorch, one timestep at a time in float32 —
for CPU tensors. There is no fallback between the two: a CUDA call that
cannot launch raises. ``rwkv6_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64)

_count_lock = threading.Lock()
_P, _I = ctypes.c_void_p, ctypes.c_int
# r, k, v, w, u, state0, y, state_out, B, S, H, hd, dtype, stream
_ARGTYPES = [_P] * 8 + [_I] * 5 + [_P]


def rwkv6_scan_plain(r, k, v, w, u, state0):
    """r,k,v,w (B,S,H,hd); u (H,hd); state0 (B,H,hd,hd). Sequential
    recurrence in float32:
      y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S + k v^T
    Returns (y (B,S,H,hd) float32, final state (B,H,hd,hd) float32)."""
    rf, kf, vf, wf = [a.float() for a in (r, k, v, w)]
    uf = u.float()
    st = state0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                               st + uf[..., None] * kv))
        st = wf[:, t, :, :, None] * st + kv
    return torch.stack(ys, dim=1), st


def _check(r, k, v, w, u, state0, out_state):
    B, S, H, hd = r.shape
    if S < 1 or hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: S={S} < 1 or head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if any(a.shape != r.shape or a.dtype != r.dtype for a in (k, v, w)):
        raise ValueError("rwkv6_scan: r, k, v, w differ in shape or dtype")
    if u.shape != (H, hd) or state0.shape != (B, H, hd, hd) or \
            u.dtype != torch.float32 or state0.dtype != torch.float32:
        raise ValueError(f"rwkv6_scan: u {tuple(u.shape)} {u.dtype} / "
                         f"state0 {tuple(state0.shape)} {state0.dtype} "
                         f"must be float32 (H,hd) / (B,H,hd,hd)")
    if out_state is not None and (out_state.shape != state0.shape or
                                  out_state.dtype != torch.float32):
        raise ValueError("rwkv6_scan: out_state must be float32 "
                         "(B,H,hd,hd)")
    ts = [r, k, v, w, u, state0] + ([out_state] if out_state is not None
                                    else [])
    if any(t.device != r.device for t in ts):
        raise ValueError("rwkv6_scan: tensors on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rwkv6_scan: the kernel takes contiguous tensors "
                         "only (no copy is made)")


def rwkv6_scan(r, k, v, w, u, state0, out_state=None):
    """r,k,v,w (B,S,H,hd) float32|bfloat16; u (H,hd) and state0
    (B,H,hd,hd) float32. Returns (y (B,S,H,hd) float32, final state). The
    final state is written into ``out_state`` when given, which may be
    ``state0`` itself (an in-place cache update)."""
    if r.device.type == "cpu":
        y, st = rwkv6_scan_plain(r, k, v, w, u, state0)
        if out_state is not None:
            st = out_state.copy_(st)
        return y, st
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    _check(r, k, v, w, u, state0, out_state)
    B, S, H, hd = r.shape
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if out_state is None:
        out_state = torch.empty_like(state0)
    launch = build.load("rwkv6_scan", "rwkv6_scan_launch", _ARGTYPES)
    err = launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state0.data_ptr(), y.data_ptr(), out_state.data_ptr(), B, S, H, hd,
        build.dtype_code(r), torch.cuda.current_stream(r.device).cuda_stream)
    build.check("rwkv6_scan", err, "rwkv6_scan")
    with _count_lock:       # engines launch from several threads
        rwkv6_scan.launches += 1
    return y, out_state


rwkv6_scan.launches = 0
