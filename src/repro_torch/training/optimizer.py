"""AdamW over dict/list trees of tensors (PyTorch counterpart of
``repro/training/optimizer.py``), with optional bf16 moment storage.

The arithmetic is the reference's, in float32 (the learning rate from a
float32 step count), so an update equals the reference's to float32
rounding. ``adamw_update`` applies it in place on the master weights and
moments, one leaf at a time: the largest leaf of RWKV-6 3B (the stacked
channel-mix key weights, 2.9 GB in float32) then needs a few leaf-sized
temporaries, not a copy of every tree.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.common import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"     # 'bfloat16' halves optimizer memory
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step):
    """Linear warm-up, then cosine decay to ``min_lr_ratio``: a float32
    tensor for a step count (int or tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clip((step - cfg.warmup_steps)
                      / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(cfg: AdamWConfig, params):
    """{'step': int32 0, 'm', 'v': zero trees in ``moment_dtype``} on the
    params' device."""
    mdt = getattr(torch, cfg.moment_dtype)
    device = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                            device=p.device), params),
    }


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """params: float32 master weights, updated in place, as are the
    moments. Returns (params, opt_state) with the step advanced."""
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    t = step.to(torch.float32)
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        g = g.to(torch.float32)
        # m32 = b1 m + (1 - b1) g; v32 = b2 v + (1 - b2) g g
        m32 = m.to(torch.float32).mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v32 = v.to(torch.float32).mul_(cfg.b2).add_(
            g.mul(1 - cfg.b2).mul_(g))
        # p - lr (m32 / c1 / (sqrt(v32 / c2) + eps) + wd p)
        upd = (m32 / c1).div_((v32 / c2).sqrt_().add_(cfg.eps))
        upd.add_(p * cfg.weight_decay)
        p.sub_(upd.mul_(lr))
        m.copy_(m32)
        v.copy_(v32)
    opt_state["step"] = step
    return params, opt_state
