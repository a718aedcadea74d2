"""RWKV-6 WKV recurrence (the time-mix scan of every RWKV-6 layer).

Replaces the Pallas TPU kernel ``src/repro/kernels/rwkv6_scan.py::
rwkv6_scan`` (``_kernel``) with a CUDA kernel written for Hopper,
``repro_torch/csrc/rwkv6_scan.cu``: a column split of the recurrence,
each thread holding a few rows x 2 columns of one ``(b, h)``'s state (32
columns per CTA and 8 rows per thread for a prefill, its inputs staged
16 steps at a time; a decode step is a kernel of its own, 16 and 4, that
stages nothing), the row groups' partial sums added once per chunk of
steps and the bonus term hoisted out of the sum over rows. That file's
header says what bounds it on the H100 and what its design does about
that.

``rwkv6_scan`` launches the kernel for CUDA tensors and runs
``rwkv6_scan_plain`` — the recurrence of ``repro/kernels/ref.py::
rwkv6_scan_ref`` in plain PyTorch, one timestep at a time in float32 —
for CPU tensors. There is no fallback between the two: a CUDA call that
cannot launch raises. ``rwkv6_scan.launches`` counts kernel launches.

``rwkv6_scan_split_plain`` mirrors the kernel's order of summation in
plain PyTorch (the row-group partials, the hoisted bonus term). Only the
tests use it.
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


def rwkv6_scan_split_plain(r, k, v, w, u, state0, rows=None):
    """The kernel's arithmetic in plain PyTorch (tests only): per step
    y_t = sum over the row groups (``rows`` consecutive rows of the state
    each; by default the kernel's: 4 for a decode step, 8 for S > 1) of
    (sum over the group's rows j of r_t[j] S[j]) + v_t * (sum_j r_t[j]
    u[j] k_t[j]), the bonus term once per step and not per column; then
    S <- diag(w_t) S + k_t v_t^T. Same arguments and results as
    ``rwkv6_scan_plain``."""
    rf, kf, vf, wf = [a.float() for a in (r, k, v, w)]
    uf = u.float()
    st = state0.float()
    B, S, H, hd = r.shape
    rows = rows or (4 if S == 1 else 8)
    groups = hd // rows
    ys = []
    for t in range(S):
        rg = rf[:, t].reshape(B, H, groups, rows)
        part = torch.einsum("bhgr,bhgrv->bhgv", rg,
                            st.reshape(B, H, groups, rows, hd))
        bonus = (rf[:, t] * uf * kf[:, t]).sum(-1)          # (B,H)
        ys.append(part.sum(2) + vf[:, t] * bonus[..., None])
        st = wf[:, t, :, :, None] * st + \
            kf[:, t, :, :, None] * vf[:, t, :, None, :]
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
    if any(t.data_ptr() % 16 for t in ts if t is not u):
        raise ValueError("rwkv6_scan: the kernel copies 16 bytes at a time; "
                         "r, k, v, w and the states must be 16-byte "
                         "aligned")


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
