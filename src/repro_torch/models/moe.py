"""Mixture-of-Experts FFN on one device (PyTorch counterpart of the
single-device half of ``repro/models/moe.py``).

The routed path computes the function of the reference's
``routed_dense``: exact top-k over a softmax of all ``E`` experts, no
capacity, no dropped tokens, gates renormalised only under
``norm_topk_prob``. The reference computes it expert-major over EVERY
expert for every token; ``routed`` computes only the selected (token,
expert) pairs: the ``T*k`` assignments are sorted by expert on the device,
each expert's three products run on its slice with ``torch.matmul``, and
gate x output lands back in assignment order, summed over the ``k``
choices of each token (in that order, so the result does not depend on
atomics). Slicing needs the per-expert counts on the host: one
device-to-host copy per MoE layer and call. These are plain products that
the reference, too, computes outside any Pallas kernel.

``routed_dense_plain`` keeps the reference's all-experts formulation. It
is the tests' oracle and is not on any serving path.

Shared experts are a plain dense FFN added to the routed output (the
DeepSeek-V3 / Qwen-MoE structure). The expert-parallel path of the
reference (``routed_ep``: capacity, ``all_to_all``) needs several devices
and is not ported yet (ROADMAP.md Queue 1, item 12).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import act_fn, dense_init, leaf_dtype


def init_moe_params(generator, cfg, dtype, device, repeat: int):
    """The reference's ``init_moe_params`` shapes and scales, stacked over
    ``repeat`` layers. ``dense_init`` there takes the fan-in from the
    unstacked tensor's first axis, so the stacked expert weights
    ``(E, d, f)`` / ``(E, f, d)`` are drawn with std ``1/sqrt(E)``. The
    router stays in float32 whatever ``dtype``, as in the reference."""
    mo = cfg.moe
    d, E, f = cfg.d_model, mo.num_experts, mo.d_expert

    def w(shape, dt=dtype):
        return dense_init(generator, (repeat, *shape), dt, device,
                          fan_in=shape[0])

    p = {"router": w((d, E), leaf_dtype("router", dtype)),
         "w_gate": w((E, d, f)), "w_up": w((E, d, f)),
         "w_down": w((E, f, d))}
    if mo.num_shared_experts:
        p["shared"] = {"w_gate": w((d, mo.d_shared)),
                       "w_up": w((d, mo.d_shared)),
                       "w_down": w((mo.d_shared, d))}
    return p


def router_probs(cfg, router_w, x2d):
    """x2d (T, d) -> (gates (T,k), idx (T,k), logits (T,E)), gates
    renormalised over the top k under ``norm_topk_prob``."""
    mo = cfg.moe
    logits = x2d.float() @ router_w.float()              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, mo.top_k, dim=-1)
    if mo.norm_topk_prob:
        gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
    return gates, idx, logits


def _balance(E, probs, counts, n_assign):
    """Switch-style load-balance loss from the softmax probs (T,E) and the
    per-expert assignment counts (E,)."""
    me = torch.mean(probs, dim=0)
    ce = counts.float() / (n_assign + 1e-9)
    return E * torch.sum(me * ce)


def aux_load_balance_loss(cfg, logits, idx):
    """Switch-style load-balance auxiliary loss (mean fraction * mean
    prob)."""
    E = cfg.moe.num_experts
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    return _balance(E, torch.softmax(logits, dim=-1), counts, idx.numel())


def _expert(act, x, w_gate, w_up, w_down):
    return (act(x @ w_gate) * (x @ w_up)) @ w_down


def routed(cfg, p, x2d):
    """Exact top-k MoE without capacity (one device), computed on the
    selected (token, expert) pairs only. x2d (T, d) -> (out (T, d),
    aux)."""
    mo = cfg.moe
    E, k = mo.num_experts, mo.top_k
    act = act_fn(cfg.act)
    gates, idx, logits = router_probs(cfg, p["router"], x2d)
    T, d = x2d.shape
    flat = idx.reshape(-1)                               # (T*k,)
    order = torch.argsort(flat, stable=True)             # expert-major
    counts = torch.bincount(flat, minlength=E)
    tok = order // k                                     # token of each
    xs = x2d[tok]                                        # (T*k, d)
    # the expert weights are unbound once, so that under autograd their
    # gradients are stacked once rather than each expert's index
    # materialising a zero-filled copy of all E
    w_gate, w_up, w_down = (p[n].unbind(0)
                            for n in ("w_gate", "w_up", "w_down"))
    parts, lo = [], 0
    for e, n in enumerate(counts.tolist()):              # the one sync
        if n:
            parts.append(_expert(act, xs[lo:lo + n], w_gate[e], w_up[e],
                                 w_down[e]))
        lo += n
    ys = torch.cat(parts)
    g = gates.reshape(-1)[order].to(ys.dtype)
    out = torch.empty_like(ys).index_copy_(0, order, ys * g[:, None])
    out = out.view(T, k, d).sum(dim=1)
    aux = _balance(E, torch.softmax(logits, dim=-1), counts, flat.numel())
    return out, aux


def routed_dense_plain(cfg, p, x2d):
    """The reference's ``routed_dense``: every expert for every token,
    combined through one-hot gates. The tests' oracle."""
    mo = cfg.moe
    act = act_fn(cfg.act)
    gates, idx, logits = router_probs(cfg, p["router"], x2d)
    oh = torch.nn.functional.one_hot(idx, mo.num_experts).to(x2d.dtype)
    combine = torch.einsum("tk,tke->te", gates.to(x2d.dtype), oh)
    h = act(torch.einsum("td,edf->tef", x2d, p["w_gate"])) * \
        torch.einsum("td,edf->tef", x2d, p["w_up"])
    y = torch.einsum("tef,efd->ted", h, p["w_down"])
    out = torch.einsum("ted,te->td", y, combine)
    return out, aux_load_balance_loss(cfg, logits, idx)


def shared_expert_ffn(cfg, p, x):
    act = act_fn(cfg.act)
    sp = p["shared"]
    return (act(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]


def moe_ffn(cfg, p, x):
    """x (B,S,d) -> (out, aux_loss): the routed experts plus the shared
    ones."""
    B, S, d = x.shape
    out2d, aux = routed(cfg, p, x.reshape(B * S, d))
    out = out2d.reshape(B, S, d)
    if cfg.moe.num_shared_experts:
        out = out + shared_expert_ffn(cfg, p, x)
    return out, aux
