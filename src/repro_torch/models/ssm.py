"""Recurrent sequence mixers (PyTorch counterpart of the RWKV-6 half of
``repro/models/ssm.py``): RWKV-6 (Finch) time mix and channel mix.

The reference runs the WKV recurrence through ``_chunked_scan``, an XLA
execution strategy (an outer scan over chunks around a checkpointed inner
scan). The port calls ``kernels.rwkv6_scan`` instead: the hand-written
CUDA kernel on the card, its plain float32 loop on the CPU. Both compute
the same recurrence, so ``_chunked_scan`` has no counterpart here.

Decode (S == 1) is a single O(1) state update. The Mamba-style branch
(``init_mamba_params``, ``mamba_branch``: Hymba's hybrid heads) is not
ported yet (ROADMAP.md Queue 1, item 10).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models.common import dense_init, group_norm_heads


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

    def full(shape, value, dt):
        return torch.full((R, *shape), value, dtype=dt, device=device)

    mix_base = torch.rand((R, 5, d), generator=generator,
                          dtype=torch.float32, device=generator.device)
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
            "w_base": full((d,), -4.0, torch.float32),
            "w_w1": dense((d, L), d),
            "w_w2": dense((L, d), L, scale=0.1),
            "u": full((H, s.head_dim), 0.0, torch.float32),
            "gn_scale": full((H, s.head_dim), 1.0, torch.float32),
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
    place)."""
    s = cfg.ssm
    B, S, d = x.shape
    H, hd = d // s.head_dim, s.head_dim

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

    y, state = rwkv6_scan(r, k, v, w, p["u"].float(), state, out_state)
    y = group_norm_heads(y.to(x.dtype), p["gn_scale"], eps=64e-5)
    out = (y.reshape(B, S, d) * g) @ p["wo"]
    return out, state, new_sx


def rwkv_channel_mix(cfg, p, x, sx):
    prev, new_sx = _token_shift(x, sx.to(x.dtype))
    dx = prev - x
    x_k = x + dx * p["mix_k"]
    x_r = x + dx * p["mix_r"]
    k = torch.square(F.relu(x_k @ p["wk"]))
    kv = k @ p["wv"]
    return torch.sigmoid(x_r @ p["wr"]) * kv, new_sx
