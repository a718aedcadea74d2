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

Training: when grad is enabled and an input requires it, ``rwkv6_scan``
goes through ``RWKV6Scan``, a ``torch.autograd.Function``. Its forward
launches K6 in a mode that also stores the state at the start of every
chunk of ``SAVE_EVERY`` steps; its backward is ``rwkv6_scan_bwd``: a
second hand-written kernel, ``repro_torch/csrc/rwkv6_scan_bwd.cu``, on
CUDA tensors (``rwkv6_scan_bwd.launches`` counts it), and
``rwkv6_scan_bwd_plain`` — the gradient formulas one step at a time — on
CPU tensors. The reference has no backward kernel: it differentiates a
checkpointed ``lax.scan`` (``repro/models/ssm.py``), which checkpoints
every 128 steps; the port saves every 16 (the forward kernel's chunk),
``B*H*hd^2*4`` bytes each (1.31 MB at RWKV-6 3B's heads, batch 2).
The backward kernel is a row split of each ``(b, h)`` over a thread
block cluster of ``hd / 16`` CTAs: each thread keeps 2 rows x 4 columns
of the state's gradient in registers and 8 recomputed states of them;
its partial row and column sums go through shared memory and are added
once per sub-chunk of 8 steps, in a fixed order, and only dv's column
sums cross CTAs, through the cluster's shared memory. Its header says
what bounds it on the H100 and what its design does about that.

``rwkv6_scan_split_plain`` and ``rwkv6_scan_bwd_split_plain`` mirror the
two kernels' orders of summation in plain PyTorch (the forward's
row-group partials and hoisted bonus term; the backward's per-thread
partials, per-CTA and per-cluster sums and deferred bonus terms). Only
the tests use them.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64)
# steps between the states the training forward saves: the forward
# kernel's chunk (TC_PREFILL in csrc/rwkv6_scan.cu, TC in rwkv6_scan_bwd.cu)
SAVE_EVERY = 16

# the backward kernel's shape (RB, R, C, U in csrc/rwkv6_scan_bwd.cu):
# state rows per CTA, rows and columns per thread, steps per sub-chunk
BWD_ROWS, BWD_THREAD_ROWS, BWD_THREAD_COLS, BWD_SUB = 16, 2, 4, 8

_count_lock = threading.Lock()
_P, _I = ctypes.c_void_p, ctypes.c_int
# r, k, v, w, u, state0, y, state_out, boundaries, B, S, H, hd, dtype, stream
_ARGTYPES = [_P] * 9 + [_I] * 5 + [_P]
# r, k, v, w, u, boundaries, dy, dstate, dr, dk, dv, dw, du, dstate0,
# B, S, H, hd, dtype, stream
_BWD_ARGTYPES = [_P] * 14 + [_I] * 5 + [_P]


def _acc_dtype(t):
    """float64 for float64 inputs (gradcheck), float32 otherwise."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def rwkv6_scan_plain(r, k, v, w, u, state0, boundaries=None):
    """r,k,v,w (B,S,H,hd); u (H,hd); state0 (B,H,hd,hd). Sequential
    recurrence in float32 (float64 for float64 inputs):
      y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S + k v^T
    Returns (y (B,S,H,hd), final state (B,H,hd,hd)). Given a list as
    ``boundaries``, appends to it the state before every step t with t %
    SAVE_EVERY == 0, as the training forward kernel stores them."""
    dt = _acc_dtype(r)
    rf, kf, vf, wf = [a.to(dt) for a in (r, k, v, w)]
    uf = u.to(dt)
    st = state0.to(dt)
    if r.device.type == "meta":     # the dry run's shape-only pass
        if boundaries is not None:
            boundaries.extend([st] * -(-r.shape[1] // SAVE_EVERY))
        return torch.empty(r.shape, dtype=dt, device=r.device), st
    ys = []
    for t in range(r.shape[1]):
        if boundaries is not None and t % SAVE_EVERY == 0:
            boundaries.append(st)
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                               st + uf[..., None] * kv))
        st = wf[:, t, :, :, None] * st + kv
    return torch.stack(ys, dim=1), st


def rwkv6_scan_bwd_plain(r, k, v, w, u, boundaries, dy, dstate=None):
    """The gradients of ``rwkv6_scan_plain`` one step at a time, in
    float32 (float64 for float64 inputs): the backward kernel's oracle and
    the CPU path. ``boundaries`` (ceil(S / SAVE_EVERY), B,H,hd,hd) are the
    states before steps 0, SAVE_EVERY, ...; each chunk's states are
    recomputed forward from its boundary. ``dy`` (B,S,H,hd) and
    ``dstate`` (B,H,hd,hd) or None (zero) are the gradients of y and of the
    final state. Walking t down with dS = dstate:
      dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
      dk_t = r_t * u * (v_t . dy_t) + dS v_t
      dv_t = (r_t * u . k_t) dy_t + dS^T k_t
      dw_t = rowsum(dS * S_{t-1})
      du  += r_t * k_t * (v_t . dy_t)
      dS  <- diag(w_t) dS + r_t dy_t^T
    Returns (dr, dk, dv, dw (B,S,H,hd), du (H,hd), dstate0 (B,H,hd,hd))."""
    dt = _acc_dtype(r)
    rf, kf, vf, wf, dyf = [a.to(dt) for a in (r, k, v, w, dy)]
    uf = u.to(dt)
    B, S, H, hd = r.shape
    ds = torch.zeros((B, H, hd, hd), dtype=dt, device=r.device) \
        if dstate is None else dstate.to(dt)
    dr, dk, dv, dw = [torch.empty((B, S, H, hd), dtype=dt, device=r.device)
                      for _ in range(4)]
    du = torch.zeros((H, hd), dtype=dt, device=r.device)
    vdy = (vf * dyf).sum(-1, keepdim=True)                  # (B,S,H,1)
    bonus = (rf * uf * kf).sum(-1, keepdim=True)            # (B,S,H,1)
    # meta tensors (the dry run's shape-only pass) take the shapes only
    chunks = () if r.device.type == "meta" else range(boundaries.shape[0])
    for n in reversed(chunks):
        t0, t1 = n * SAVE_EVERY, min(S, (n + 1) * SAVE_EVERY)
        st, prev = boundaries[n].to(dt), []
        for t in range(t0, t1):
            prev.append(st)
            st = wf[:, t, :, :, None] * st + \
                kf[:, t, :, :, None] * vf[:, t, :, None, :]
        for t in reversed(range(t0, t1)):
            sp, dyt = prev[t - t0], dyf[:, t]
            dr[:, t] = torch.einsum("bhkv,bhv->bhk", sp, dyt) + \
                uf * kf[:, t] * vdy[:, t]
            dk[:, t] = rf[:, t] * uf * vdy[:, t] + \
                torch.einsum("bhkv,bhv->bhk", ds, vf[:, t])
            dv[:, t] = bonus[:, t] * dyt + \
                torch.einsum("bhkv,bhk->bhv", ds, kf[:, t])
            dw[:, t] = (ds * sp).sum(-1)
            du += (rf[:, t] * kf[:, t] * vdy[:, t]).sum(0)
            ds = wf[:, t, :, :, None] * ds + \
                rf[:, t, :, :, None] * dyt[:, :, None, :]
    return dr, dk, dv, dw, du, ds


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


def _seq_sum(x, dim):
    """Sum over ``dim`` one term after another, in index order."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _tree_sum(x):
    """Sum over the last dim (a power of two) as a warp's xor-shuffle
    butterfly leaves it in lane 0: halves added pairwise."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def rwkv6_scan_bwd_split_plain(r, k, v, w, u, boundaries, dy, dstate=None):
    """The backward kernel's arithmetic in plain PyTorch, float32 (tests
    only); same arguments and results as ``rwkv6_scan_bwd_plain``. Each
    (b, h) is split into blocks of BWD_ROWS state rows (a CTA of the
    kernel; one block of all rows when hd is smaller), each block into
    threads of BWD_THREAD_ROWS rows x BWD_THREAD_COLS columns. Per chunk of
    SAVE_EVERY steps, v_t . dy_t and each block's share of the bonus sum
    (r_t u k_t over its rows) are sums over the kernel's lanes per step (a
    butterfly); per sub-chunk of BWD_SUB
    steps, the later first, the states are recomputed from the chunk's
    boundary and each step's thread partials kept (dr, dk, dw of a
    thread's rows over its columns, dv of its columns over its rows, each
    a sum in order); after the sub-chunk dr, dk, dw add their threads'
    partials in column order and then the bonus terms, and dv adds them in
    row order per block, the blocks in order, then the bonus sum (the
    blocks' shares in order) times dy_t. du adds r_t k_t (v_t . dy_t) per
    step, the steps of a chunk in order, the chunks from the last."""
    rf, kf, vf, wf, dyf = [a.float() for a in (r, k, v, w, dy)]
    uf = u.float()
    B, S, H, hd = r.shape
    RB, R, C = min(BWD_ROWS, hd), BWD_THREAD_ROWS, BWD_THREAD_COLS
    NB, RG, NCG = hd // RB, RB // R, hd // C
    lanes = max(1, RG * NCG // SAVE_EVERY)
    ds = torch.zeros((B, H, hd, hd), device=r.device) if dstate is None \
        else dstate.float().clone()
    dr, dk, dv, dw = [torch.empty((B, S, H, hd), device=r.device)
                      for _ in range(4)]
    du = torch.zeros((B, H, hd), device=r.device)
    # meta tensors (the dry run's shape-only pass) take the shapes only
    chunks = () if r.device.type == "meta" else range(boundaries.shape[0])
    for n in reversed(chunks):
        t0, t1 = n * SAVE_EVERY, min(S, (n + 1) * SAVE_EVERY)
        vdy = {t: _tree_sum(_seq_sum(
            (vf[:, t] * dyf[:, t]).reshape(B, H, lanes, hd // lanes), -1))
            for t in range(t0, t1)}                              # (B,H)
        bonp = {t: _tree_sum(_seq_sum(
            (rf[:, t] * uf * kf[:, t]).reshape(B, H, NB, lanes, RB // lanes),
            -1)) for t in range(t0, t1)}                         # (B,H,NB)
        for a0 in reversed(range(t0, t1, BWD_SUB)):
            a1 = min(t1, a0 + BWD_SUB)
            st = boundaries[n].float()
            for t in range(t0, a0):
                st = wf[:, t, :, :, None] * st + \
                    kf[:, t, :, :, None] * vf[:, t, :, None, :]
            prev = []
            for t in range(a0, a1):
                prev.append(st)
                st = wf[:, t, :, :, None] * st + \
                    kf[:, t, :, :, None] * vf[:, t, :, None, :]
            parts = {}
            for t in reversed(range(a0, a1)):
                sp = prev[t - a0].reshape(B, H, hd, NCG, C)
                d4 = ds.reshape(B, H, hd, NCG, C)
                dyc = dyf[:, t].reshape(B, H, 1, NCG, C)
                vc = vf[:, t].reshape(B, H, 1, NCG, C)
                pv = _seq_sum((ds * kf[:, t, :, :, None]).reshape(
                    B, H, NB, RG, R, hd), 4)              # (B,H,NB,RG,hd)
                parts[t] = (_seq_sum(sp * dyc, -1), _seq_sum(d4 * vc, -1),
                            _seq_sum(d4 * sp, -1), pv)
                ds = wf[:, t, :, :, None] * ds + \
                    rf[:, t, :, :, None] * dyf[:, t, :, None, :]
            for t in range(a0, a1):
                pr, pk, pw, pv = parts[t]
                dr[:, t] = _seq_sum(pr, -1) + uf * kf[:, t] * \
                    vdy[t][..., None]
                dk[:, t] = _seq_sum(pk, -1) + rf[:, t] * uf * \
                    vdy[t][..., None]
                dw[:, t] = _seq_sum(pw, -1)
                dv[:, t] = _seq_sum(_seq_sum(pv, 3), 2) + \
                    _seq_sum(bonp[t], -1)[..., None] * dyf[:, t]
        for t in range(t0, t1):
            du = du + rf[:, t] * kf[:, t] * vdy[t][..., None]
    return dr, dk, dv, dw, du.sum(0), ds


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


def _launch(r, k, v, w, u, state0, out_state=None, save=False):
    """K6 on CUDA tensors. With ``save`` also returns the boundary states
    (ceil(S / SAVE_EVERY), B,H,hd,hd) the kernel stored."""
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    _check(r, k, v, w, u, state0, out_state)
    B, S, H, hd = r.shape
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    if out_state is None:
        out_state = torch.empty_like(state0)
    bnd = torch.empty((-(-S // SAVE_EVERY), B, H, hd, hd),
                      dtype=torch.float32, device=r.device) if save else None
    launch = build.load("rwkv6_scan", "rwkv6_scan_launch", _ARGTYPES)
    err = launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state0.data_ptr(), y.data_ptr(), out_state.data_ptr(),
        None if bnd is None else bnd.data_ptr(), B, S, H, hd,
        build.dtype_code(r), torch.cuda.current_stream(r.device).cuda_stream)
    build.check("rwkv6_scan", err, "rwkv6_scan")
    with _count_lock:       # engines launch from several threads
        rwkv6_scan.launches += 1
    return (y, out_state, bnd) if save else (y, out_state)


def rwkv6_scan_save(r, k, v, w, u, state0):
    """The training forward: (y, final state, boundaries), the boundaries
    (ceil(S / SAVE_EVERY), B,H,hd,hd) being the states before steps 0,
    SAVE_EVERY, ...: K6 storing them on CUDA tensors (one launch, counted
    by ``rwkv6_scan.launches``), the plain recurrence on CPU tensors."""
    if build.plain_device(r):
        bnd = []
        y, st = rwkv6_scan_plain(r, k, v, w, u, state0, bnd)
        return y, st, torch.stack(bnd)
    return _launch(r, k, v, w, u, state0, save=True)


def rwkv6_scan_bwd(r, k, v, w, u, boundaries, dy, dstate=None):
    """The gradients of K6 (see ``rwkv6_scan_bwd_plain`` for the
    arguments and results): the backward kernel on CUDA tensors, which
    returns them in float32; the plain version on CPU tensors."""
    if build.plain_device(r):
        return rwkv6_scan_bwd_plain(r, k, v, w, u, boundaries, dy, dstate)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_bwd: unsupported device {r.device}")
    _check(r, k, v, w, u, boundaries[0], None)
    B, S, H, hd = r.shape
    ts = [boundaries, dy] + ([dstate] if dstate is not None else [])
    if boundaries.shape != (-(-S // SAVE_EVERY), B, H, hd, hd) or \
            dy.shape != r.shape or \
            (dstate is not None and dstate.shape != (B, H, hd, hd)) or \
            any(t.dtype != torch.float32 or t.device != r.device or
                not t.is_contiguous() or t.data_ptr() % 16 for t in ts):
        raise ValueError("rwkv6_scan_bwd: boundaries, dy and dstate must "
                         "be contiguous, 16-byte aligned float32 of K6's "
                         "shapes on r's device")
    dr, dk, dv, dw = [torch.empty(r.shape, dtype=torch.float32,
                                  device=r.device) for _ in range(4)]
    du = torch.empty((B, H, hd), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    launch = build.load("rwkv6_scan_bwd", "rwkv6_scan_bwd_launch",
                        _BWD_ARGTYPES)
    err = launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        boundaries.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(), B, S, H, hd, build.dtype_code(r),
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check("rwkv6_scan_bwd", err, "rwkv6_scan_bwd")
    with _count_lock:
        rwkv6_scan_bwd.launches += 1
    return dr, dk, dv, dw, du.sum(0), ds0


rwkv6_scan_bwd.launches = 0


class RWKV6Scan(torch.autograd.Function):
    """K6 under autograd: the forward saves the boundary states, the
    backward recomputes each chunk's states from them (``rwkv6_scan_bwd``).
    Gradients come back in each input's dtype."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        y, st, bnd = rwkv6_scan_save(r, k, v, w, u, state0)
        ctx.save_for_backward(r, k, v, w, u, bnd)
        ctx.state_dtype = state0.dtype
        ctx.set_materialize_grads(False)
        return y, st

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, bnd = ctx.saved_tensors
        dy = torch.zeros(r.shape, dtype=bnd.dtype, device=r.device) \
            if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        dr, dk, dv, dw, du, ds0 = rwkv6_scan_bwd(r, k, v, w, u, bnd, dy,
                                                 dstate)
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
                dw.to(w.dtype), du.to(u.dtype), ds0.to(ctx.state_dtype))


def rwkv6_scan(r, k, v, w, u, state0, out_state=None):
    """r,k,v,w (B,S,H,hd) float32|bfloat16; u (H,hd) and state0
    (B,H,hd,hd) float32. Returns (y (B,S,H,hd) float32, final state). The
    final state is written into ``out_state`` when given, which may be
    ``state0`` itself (an in-place cache update). When grad is enabled and
    an input requires it, the call goes through ``RWKV6Scan``, which
    writes no ``out_state``: serving never takes gradients."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state0)):
        if out_state is not None:
            raise ValueError("rwkv6_scan: out_state is a serving cache "
                             "update; under autograd the final state is "
                             "returned instead")
        return RWKV6Scan.apply(r, k, v, w, u, state0)
    if build.plain_device(r):
        y, st = rwkv6_scan_plain(r, k, v, w, u, state0)
        if out_state is not None:
            st = out_state.copy_(st)
        return y, st
    return _launch(r, k, v, w, u, state0, out_state)


rwkv6_scan.launches = 0
