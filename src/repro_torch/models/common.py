"""Shared building blocks: norms, activations, RoPE, initializers.

PyTorch counterpart of ``repro/models/common.py``: the same arithmetic, in
float32 where the reference computes in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# leaves that the reference initialises in float32 whatever the model's
# dtype (the MoE router, the Mamba branch's dt_bias / A_log / D, RWKV-6's
# decay base, bonus and group-norm scale): the init functions and
# bridge.to_torch both take their dtype from leaf_dtype
FP32_LEAVES = frozenset({"router", "dt_bias", "A_log", "D", "w_base", "u",
                         "gn_scale"})


def leaf_dtype(name: str, dtype):
    """The dtype of the params leaf ``name`` in a model of ``dtype``."""
    return torch.float32 if name in FP32_LEAVES else dtype


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts/lists (params, caches) of
    the same structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of nested dicts/lists, in insertion order (``tree_map``'s
    order; a checkpoint's order is ``training/checkpoint.py``'s)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def group_norm_heads(x, scale, eps: float = 1e-5):
    """Per-head group norm over the last dim. x: (..., H, hd)."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE

def rope_freqs(head_dim: int, theta: float, rotary_dim: int | None = None,
               device=None):
    rd = rotary_dim if rotary_dim is not None else head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    return 1.0 / (theta ** exps)     # (rd/2,)


def apply_rope(x, positions, theta: float, kind: str = "neox"):
    """x: (B, S, H, hd) or (B, S, hd); positions: (S,) or (B, S) int.

    kind: 'neox' rotates the full head dim (half-split layout),
          'half' rotates only the first half of head dims (ChatGLM 2D RoPE),
          'none' is identity.
    """
    if kind == "none":
        return x
    if kind not in ("neox", "half"):
        raise ValueError(f"unknown rope kind {kind!r}")
    hd = x.shape[-1]
    rd = hd if kind == "neox" else hd // 2
    inv = rope_freqs(hd, theta, rd, device=x.device)
    positions = torch.as_tensor(positions, device=x.device)
    if positions.ndim == 1:
        positions = positions[None]     # (1, S)
    ang = positions.float()[..., None] * inv          # (B|1, S, rd/2)
    if x.ndim == 4:                     # head axis present
        ang = ang[..., None, :]         # (B|1, S, 1, rd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    rot, rest = x[..., :rd], x[..., rd:]
    x1, x2 = rot[..., : rd // 2], rot[..., rd // 2:]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), rest], dim=-1)


# ---------------------------------------------------------------------------
# Init helpers: the shapes and scales of the reference's initializers, drawn
# from an explicit torch.Generator (the numbers differ from jax.random's).

def draw_device(generator, device):
    """Where a draw happens: the generator's device, or ``device`` for
    ``generator=None`` (torch's default generator; on the meta device,
    which ``transformer.param_shapes`` uses, nothing is drawn)."""
    return device if generator is None else generator.device


def dense_init(generator, shape, dtype, device, scale: float | None = None,
               fan_in: int | None = None):
    """``fan_in`` defaults to shape[0]; stacked (repeat-leading) weights
    pass the per-layer fan-in."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = (scale if scale is not None else 1.0) / (fan_in ** 0.5)
    # scaled in place: a stacked expert tensor (Qwen1.5-MoE's w_gate is
    # 16.6 GB in fp32) is never held twice
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=draw_device(generator, device)).mul_(std)
    return w.to(device=device, dtype=dtype)


def embed_init(generator, shape, dtype, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=draw_device(generator, device)).mul_(0.02)
    return w.to(device=device, dtype=dtype)
