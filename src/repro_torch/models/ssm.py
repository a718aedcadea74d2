"""Recurrent sequence mixers (PyTorch counterpart of
``repro/models/ssm.py``): RWKV-6 (Finch) time mix and channel mix, and
the Mamba-style selective SSM branch of Hymba's hybrid layers.

The reference runs both recurrences through ``_chunked_scan``, an XLA
execution strategy (an outer scan over chunks around a checkpointed inner
scan). For RWKV-6 the port calls ``kernels.rwkv6_scan`` instead: the
hand-written CUDA kernel on the card, its plain float32 loop on the CPU.
The Mamba scan has no Pallas kernel in the reference, so the port runs it
as plain PyTorch on every device: a step loop over the sequence (the
reference's ``lax.scan``), one fused multiply-add launch per step, with
the decays and inputs of every step computed up front.

Decode (S == 1) is a single O(1) state update. Both branches ignore
``pos``: their state absorbs every token they are given, padding
included, as in the reference (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models.common import (dense_init, draw_device,
                                       group_norm_heads, leaf_dtype)
from repro_torch.models.sharding import (model_span, all_gather,
                                         all_reduce, materialize,
                                         model_block)


def _token_shift(x, sx):
    """x (B,S,d), sx (B,d) last token of previous chunk -> previous-token
    tensor (B,S,d) and new sx."""
    prev = torch.cat([sx[:, None, :], x[:, :-1, :]], dim=1)
    return prev, x[:, -1, :]


# ===========================================================================
# RWKV-6

def init_rwkv_params(generator, cfg, dtype, device, repeat: int):
    """The reference's ``init_rwkv_params`` shapes and scales, stacked
    over ``repeat`` layers. ``dense_init`` takes the fan-in from the
    UNSTACKED tensor's first axis, so ``mix_w2 (5, L, d)`` has fan-in 5
    and ``w_w2 (L, d)`` fan-in L."""
    d = cfg.d_model
    s = cfg.ssm
    H = d // s.head_dim
    L = s.lora_rank
    R = repeat

    def dense(shape, fan_in, scale=None):
        return dense_init(generator, (R, *shape), dtype, device, scale=scale,
                          fan_in=fan_in)

    def full(shape, value, dt=dtype):
        return torch.full((R, *shape), value, dtype=dt, device=device)

    mix_base = torch.rand((R, 5, d), generator=generator,
                          dtype=torch.float32,
                          device=draw_device(generator, device))
    return {
        "tm": {
            "mix_base": mix_base.to(device=device, dtype=dtype),
            "mix_w1": dense((d, 5 * L), d),
            "mix_w2": dense((5, L, d), 5, scale=0.1),
            "wr": dense((d, d), d),
            "wk": dense((d, d), d),
            "wv": dense((d, d), d),
            "wg": dense((d, d), d),
            "wo": dense((d, d), d),
            "w_base": full((d,), -4.0, leaf_dtype("w_base", dtype)),
            "w_w1": dense((d, L), d),
            "w_w2": dense((L, d), L, scale=0.1),
            "u": full((H, s.head_dim), 0.0, leaf_dtype("u", dtype)),
            "gn_scale": full((H, s.head_dim), 1.0,
                             leaf_dtype("gn_scale", dtype)),
        },
        "cm": {
            "mix_k": full((d,), 0.5, dtype),
            "mix_r": full((d,), 0.5, dtype),
            "wk": dense((d, cfg.d_ff), d),
            "wv": dense((cfg.d_ff, d), cfg.d_ff),
            "wr": dense((d, d), d),
        },
    }


def rwkv_time_mix(cfg, p, x, state, sx, out_state=None):
    """x (B,S,d); state (B,H,hd,hd) fp32; sx (B,d) previous token.
    Returns (out, new_state, new_sx). The new state is written into
    ``out_state`` when given (which may be ``state``: the cache, in
    place). H is ``u``'s row count: given the heads of one rank
    (``rwkv_time_mix_tp``'s local params) it computes those heads, and
    ``out`` is that rank's partial sum through its rows of ``wo``."""
    hd = cfg.ssm.head_dim
    B, S, d = x.shape
    H = p["u"].shape[0]

    prev, new_sx = _token_shift(x, sx.to(x.dtype))
    dx = prev - x
    # data-dependent token-shift mixing (ddlerp)
    xxx = x + dx * p["mix_base"][0].to(x.dtype)
    t = torch.tanh(xxx @ p["mix_w1"]).reshape(B, S, 5, -1)
    mix = p["mix_base"].float() + torch.einsum(
        "bsfl,fld->bsfd", t.float(), p["mix_w2"].float())
    xs = x[:, :, None, :] + dx[:, :, None, :] * mix.to(x.dtype)
    x_w, x_k, x_v, x_r, x_g = xs.unbind(2)

    r = (x_r @ p["wr"]).reshape(B, S, H, hd)
    k = (x_k @ p["wk"]).reshape(B, S, H, hd)
    v = (x_v @ p["wv"]).reshape(B, S, H, hd)
    g = F.silu(x_g @ p["wg"])
    # data-dependent decay in (0, 1)
    ww = p["w_base"] + (torch.tanh(x_w @ p["w_w1"]) @ p["w_w2"]).float()
    w = torch.exp(-torch.exp(ww.float())).reshape(B, S, H, hd)

    # the recurrence runs in float32 whatever the compute dtype, as the
    # reference's scan step casts r, k, v (and w, float32 already) to it
    y, state = rwkv6_scan(r.float(), k.float(), v.float(), w,
                          p["u"].float(), state, out_state)
    y = group_norm_heads(y.to(x.dtype), p["gn_scale"], eps=64e-5)
    out = (y.reshape(B, S, H * hd) * g) @ p["wo"]
    return out, state, new_sx


def rwkv_tp(cfg, mesh, state_spec=None) -> bool:
    """Whether an RWKV layer computes its time mix over this rank's H / tp
    heads: where a cache's state holds its heads over 'model'
    (``state_spec``, ``shard_rules.cache_spec``), or, without a cache,
    where H divides over 'model' and 'model' is no batch axis."""
    from repro_torch.launch import optflags
    if state_spec is not None:
        return state_spec[2] == "model"
    H = cfg.d_model // cfg.ssm.head_dim
    return "model" in mesh.axis_names and not optflags.has("flat_dp") and \
        H % mesh.shape["model"] == 0


def rwkv_time_mix_tp(cfg, p, ps, x, state, sx, out_state, mesh):
    """The time mix over this rank's H / tp heads (``rwkv_tp``): ``wr``,
    ``wk``, ``wv`` column-parallel (their rule puts 'model' on the output
    dim); ``wg``, which has no rule, and ``w_base``, ``u``, ``gn_scale``
    cut to the local heads from their replicated leaves; ``w_w2`` gives
    the local heads' decay; the mixes need every channel (they feed
    projections from d), so ``mix_w2`` is gathered whole; ``wo``
    row-parallel, then an all-reduce over 'model'. K6 runs at the local
    head count on the local state (B, H/tp, hd, hd). ``p`` / ``ps``: this
    rank's shards of the ``tm`` leaves and their specs."""
    def blk(name, dim):
        return model_block(p[name], ps[name], dim, mesh)
    lp = {n: materialize(p[n], ps[n])
          for n in ("mix_base", "mix_w1", "mix_w2", "w_w1")}
    lp.update(wr=blk("wr", 1), wk=blk("wk", 1), wv=blk("wv", 1),
              wg=blk("wg", 1), w_base=blk("w_base", 0), w_w2=blk("w_w2", 1),
              u=blk("u", 0), gn_scale=blk("gn_scale", 0), wo=blk("wo", 0))
    out, state, new_sx = rwkv_time_mix(cfg, lp, x, state, sx, out_state)
    return all_reduce(out, "model"), state, new_sx


def rwkv_channel_mix(cfg, p, x, sx):
    prev, new_sx = _token_shift(x, sx.to(x.dtype))
    dx = prev - x
    x_k = x + dx * p["mix_k"]
    x_r = x + dx * p["mix_r"]
    k = torch.square(F.relu(x_k @ p["wk"]))
    kv = k @ p["wv"]
    return torch.sigmoid(x_r @ p["wr"]) * kv, new_sx


def rwkv_channel_mix_tp(cfg, p, ps, x, sx, mesh):
    """The channel mix with f split over 'model': ``wk`` (d, f) column-
    parallel as its rule has it; ``wv`` (f, d) is named like attention's
    value projection, whose rule ('fsdp', 'tp') puts 'model' on d, not on
    f, so it is gathered and cut to this rank's f rows, and the partial
    k @ wv all-reduced; ``wr`` column-parallel, the receptance's local
    channels all-gathered over 'model'."""
    prev, new_sx = _token_shift(x, sx.to(x.dtype))
    dx = prev - x
    mix_k, mix_r = (materialize(p[n], ps[n]) for n in ("mix_k", "mix_r"))
    x_k = x + dx * mix_k
    x_r = x + dx * mix_r
    k = torch.square(F.relu(x_k @ model_block(p["wk"], ps["wk"], 1, mesh)))
    kv = all_reduce(k @ model_block(p["wv"], ps["wv"], 0, mesh), "model")
    r = torch.sigmoid(x_r @ model_block(p["wr"], ps["wr"], 1, mesh))
    return all_gather(r, "model", -1) * kv, new_sx


# ===========================================================================
# Mamba-style selective SSM (Hymba's parallel SSM heads)

def init_mamba_params(generator, cfg, dtype, device, repeat: int):
    """The reference's ``init_mamba_params`` shapes and scales, stacked
    over ``repeat`` layers (``conv_w (cw, dI)`` has fan-in ``cw``, as the
    reference's ``dense_init`` takes it). ``dt_bias``, ``A_log`` and ``D``
    are float32 whatever ``dtype``."""
    s = cfg.ssm
    d = cfg.d_model
    dI = d                       # inner dim == d_model (parallel heads)
    N, Rk = s.state_dim, s.dt_rank
    R = repeat

    def dense(shape):
        return dense_init(generator, (R, *shape), dtype, device,
                          fan_in=shape[0])

    a = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                               device=device))
    return {
        "w_in": dense((d, 2 * dI)),
        "conv_w": dense((s.conv_dim, dI)),
        "conv_b": torch.zeros((R, dI), dtype=dtype, device=device),
        "w_x": dense((dI, Rk + 2 * N)),
        "w_dt": dense((Rk, dI)),
        "dt_bias": torch.full((R, dI), -4.6,
                              dtype=leaf_dtype("dt_bias", dtype),
                              device=device),
        "A_log": a.expand(R, dI, N).to(leaf_dtype("A_log", dtype)).clone(),
        "D": torch.ones((R, dI), dtype=leaf_dtype("D", dtype),
                        device=device),
        "out_proj": dense((dI, d)),
    }


def mamba_branch(cfg, p, x, h_state, conv_state, reduce=None):
    """x (B,S,d); h_state (B,dI,N) fp32; conv_state (B,cw-1,dI).
    Returns (out (B,S,d), h_state, conv_state), new tensors. dI is
    ``D``'s length: given one rank's channels (``mamba_branch_tp``'s local
    params) it computes those, ``reduce`` sums the partial x_c @ w_x over
    the ranks, and ``out`` is the rank's partial sum through its rows of
    ``out_proj``."""
    s = cfg.ssm
    B, S, d = x.shape
    N, cw = s.state_dim, s.conv_dim
    dI = p["D"].shape[-1]

    xz = x @ p["w_in"]
    x_in, z = xz[..., :dI], xz[..., dI:]

    # causal depthwise conv with carried state
    ctx = torch.cat([conv_state.to(x.dtype), x_in], dim=1)
    new_conv_state = ctx[:, -(cw - 1):, :].float()
    wins = torch.stack([ctx[:, i:i + S, :] for i in range(cw)], dim=2)
    x_c = F.silu(torch.einsum("bswd,wd->bsd", wins, p["conv_w"])
                 + p["conv_b"])

    xdb = x_c @ p["w_x"]
    if reduce is not None:
        xdb = reduce(xdb)
    R = s.dt_rank
    dt = F.softplus((xdb[..., :R] @ p["w_dt"]).float() + p["dt_bias"])
    Bc = xdb[..., R:R + N].float()                          # (B,S,N)
    Cc = xdb[..., R + N:].float()                           # (B,S,N)
    A = -torch.exp(p["A_log"].float())                      # (dI,N)

    # h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t = h_t . C_t
    xf = x_c.float()
    da = torch.exp(dt[..., None] * A)                       # (B,S,dI,N)
    dbx = (dt * xf)[..., None] * Bc[:, :, None, :]          # (B,S,dI,N)
    h = h_state.float()
    if dbx.device.type == "meta":
        # the dry run's shape-only pass: one step over every position
        # stands for the S steps (the same shapes and dependencies,
        # without an S-step Python loop under autograd)
        hs = torch.addcmul(dbx, da, h[:, None])
    else:
        steps = []
        for t in range(S):
            h = torch.addcmul(dbx[:, t], da[:, t], h)
            steps.append(h)
        hs = torch.stack(steps, dim=1)
    y = torch.einsum("bsdn,bsn->bsd", hs, Cc)
    y = y + p["D"] * xf
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return out, h, new_conv_state


def mamba_tp(cfg, mesh, h_spec=None) -> bool:
    """Whether the Mamba branch computes this rank's dI / tp channels:
    where a cache's ssm_h holds dI over 'model' (``h_spec``), or, without
    a cache, where dI divides over 'model' and 'model' is no batch axis."""
    from repro_torch.launch import optflags
    if h_spec is not None:
        return h_spec[2] == "model"
    return "model" in mesh.axis_names and not optflags.has("flat_dp") and \
        cfg.d_model % mesh.shape["model"] == 0


def mamba_branch_tp(cfg, p, ps, x, h_state, conv_state, mesh):
    """The Mamba branch over this rank's dI / tp channels (the reference's
    ssm_h spec puts dI over 'model'): ``conv_w``, ``w_dt``, ``A_log`` as
    their rules split them, ``D``, ``dt_bias``, ``conv_b`` (no rule) cut
    from their replicated leaves; ``w_x``'s dI rows, whose partial product
    (B, S, R + 2N) is small, all-reduced; ``out_proj`` (no rule) its local
    rows, then an all-reduce. ``w_in`` (d, 2 dI) is [x_in | z]: its column
    split over 'model' does not give a rank the same dI range of both
    halves, so it is gathered and both halves cut. h_state: the local
    (B, dI/tp, N); conv_state: the whole (B, cw-1, dI), its local channels
    read and the new state all-gathered back."""
    def blk(name, dim):
        return model_block(p[name], ps[name], dim, mesh)
    dI = cfg.d_model
    start, n = model_span(dI, mesh)
    w_in = materialize(p["w_in"], ps["w_in"])
    lp = {"w_in": torch.cat([w_in[..., start:start + n],
                             w_in[..., dI + start:dI + start + n]], -1),
          "conv_w": blk("conv_w", 1), "conv_b": blk("conv_b", 0),
          "w_x": blk("w_x", 0), "w_dt": blk("w_dt", 1),
          "dt_bias": blk("dt_bias", 0), "A_log": blk("A_log", 0),
          "D": blk("D", 0), "out_proj": blk("out_proj", 0)}
    out, h, conv = mamba_branch(
        cfg, lp, x, h_state, conv_state[..., start:start + n],
        reduce=lambda t: all_reduce(t, "model"))
    return all_reduce(out, "model"), h, all_gather(conv, "model", -1)
