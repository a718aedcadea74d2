"""Mixture-of-Experts FFN on one device (PyTorch counterpart of the
single-device half of ``repro/models/moe.py``).

The routed path computes the function of the reference's
``routed_dense``: exact top-k over a softmax of all ``E`` experts, no
capacity, no dropped tokens, gates renormalised only under
``norm_topk_prob``. The reference computes it expert-major over EVERY
expert for every token; ``routed`` computes only the selected (token,
expert) pairs. The ``T*k`` assignments are sorted by expert on the device
(``order``, and ``offsets`` where each expert's rows start); gate x output
lands back in assignment order, summed over the ``k`` choices of each
token (in that order, so the result does not depend on atomics). Two
forms, chosen by shape, which the host knows without a sync:

- grouped (no gradient needed and ``T*k <= GROUPED_MAX_ASSIGN``: decode
  steps, verify chunks, small prefills): ``kernels/moe_experts.py``, a
  hand-written kernel that reads the routing on the device, two launches
  a layer and nothing read back;
- sorted (training under autograd, large prefills): each touched
  expert's three products on its slice with ``torch.matmul``, which needs
  the per-expert counts on the host: one device-to-host copy per MoE layer
  and call, amortised over milliseconds of products. These are plain
  products that the reference, too, computes outside any Pallas kernel.

``routed_dense_plain`` keeps the reference's all-experts formulation. It
is the tests' oracle and is not on any serving path.

Shared experts are a plain dense FFN added to the routed output (the
DeepSeek-V3 / Qwen-MoE structure).

Under an active mesh with a 'model' axis of more than one rank,
``moe_ffn`` takes the reference's expert-parallel path, ``routed_ep``:
each rank routes its own slice of the tokens (the local batch split
over 'model'), with a per-sender capacity per expert and GShard-style
dropping at ``capacity_factor``; dispatch and combine are two
``all_to_all`` calls over the EP axes ('model', or 'model' x 'data'
under the ep_all_axes flag); experts are padded up to a multiple of the
EP group and each rank computes its own. Its shapes do not depend on the
routing, so it needs no host sync. Shared experts are then a
tensor-parallel dense FFN.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels.moe_experts import moe_experts, sorted_products
from repro_torch.models.common import act_fn, dense_init, leaf_dtype
from repro_torch.models.sharding import (active_mesh, all_gather,
                                         all_reduce, all_to_all, entry,
                                         materialize, materialize_tree)


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


# T * top_k at or below which a call that needs no gradient takes the
# grouped kernel. On the H100 at Qwen1.5-MoE's shapes the grouped path is
# faster than the sorted one up to here both per call and in device time;
# at 2048 it is still faster per call but takes 1.3x the device time
# (PERF.md, the crossover table)
GROUPED_MAX_ASSIGN = 1024


def routed(cfg, p, x2d):
    """Exact top-k MoE without capacity (one device), computed on the
    selected (token, expert) pairs only. x2d (T, d) -> (out (T, d),
    aux). Tracing on, one ``moe.dispatch`` span from the router product
    to the combine (``T``, ``path`` "grouped" or "sorted"; on the sorted
    path also ``experts`` touched, and its host sync a ``readback`` inside
    it)."""
    path = "grouped" if _grouped(cfg, p, x2d) else "sorted"
    sp, attrs = tracing.start("moe.dispatch"), {}
    try:
        out, aux, attrs = _routed(cfg, p, x2d, path)
    finally:
        if sp is not None:
            sp.end(T=x2d.shape[0], path=path, **attrs)
    return out, aux


def _grouped(cfg, p, x2d) -> bool:
    if x2d.shape[0] * cfg.moe.top_k > GROUPED_MAX_ASSIGN:
        return False
    return not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (x2d, p["router"], p["w_gate"], p["w_up"],
                                  p["w_down"])))


def _route(E, idx):
    """The ``T*k`` assignments sorted by expert on the device: (order, the
    stable argsort of the flat experts; offsets (E+1,), where each
    expert's rows of ``order`` start)."""
    experts, order = torch.sort(idx.reshape(-1), stable=True)
    offsets = torch.searchsorted(
        experts, torch.arange(E + 1, device=idx.device))
    return order, offsets


def _routed(cfg, p, x2d, path):
    mo = cfg.moe
    E, k = mo.num_experts, mo.top_k
    gates, idx, logits = router_probs(cfg, p["router"], x2d)
    T, d = x2d.shape
    order, offsets = _route(E, idx)
    counts = offsets.diff()
    weights = (p["w_gate"], p["w_up"], p["w_down"])
    if path == "grouped":
        ys, attrs = moe_experts(x2d, order, offsets, gates, *weights,
                                cfg.act, k), {}
    else:
        ys, touched = sorted_products(
            act_fn(cfg.act), x2d, order,
            tracing.readback(counts.tolist),             # the one sync
            gates, *weights, k)
        attrs = {"experts": touched}
    out = ys.view(T, k, d).sum(dim=1)
    aux = _balance(E, torch.softmax(logits, dim=-1), counts, T * k)
    return out, aux, attrs


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


# ---------------------------------------------------------------------------
# expert parallelism (explicit SPMD under an active mesh)

def _expert_ffn(act, xg, w_gate, w_up, w_down):
    """xg (E, C, d); weights (E, d, f)/(E, f, d)."""
    h = act(torch.einsum("ecd,edf->ecf", xg, w_gate)) * \
        torch.einsum("ecd,edf->ecf", xg, w_up)
    return torch.einsum("ecf,efd->ecd", h, w_down)


def _ep_local(cfg, act, x_local, router_w, w_gate, w_up, w_down, *,
              tp_size: int, ep):
    """This rank's routed output for its tokens x_local (Tl, d), and the
    load-balance loss of its routing. The expert weights are this rank's
    E_pad / tp_size experts, whole (experts padded up to a multiple of
    the EP group receive no tokens)."""
    mo = cfg.moe
    El = w_gate.shape[0]                   # local (padded) experts
    E_pad = El * tp_size
    Tl, d = x_local.shape
    k = mo.top_k

    gates, idx, logits = router_probs(cfg, router_w, x_local)
    # per-sender capacity per expert (based on the REAL expert count)
    cap = max(1, int(Tl * k / mo.num_experts * mo.capacity_factor))

    # slot of each assignment, token-major: its exclusive count among the
    # earlier assignments to the same expert
    eid = idx.reshape(-1)                                  # (Tl*k,)
    gat = gates.reshape(-1).to(x_local.dtype)
    onehot = (eid[:, None] == torch.arange(
        E_pad, device=eid.device)[None, :]).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot          # exclusive
    pos = torch.sum(pos_in_e * onehot, dim=-1)               # (Tl*k,)
    keep = pos < cap
    slot = eid * cap + torch.clamp(pos, max=cap - 1)

    # scatter the kept tokens into the send buffer (E_pad*cap, d)
    tok = x_local.repeat_interleave(k, dim=0)                # (Tl*k, d)
    send = torch.zeros((E_pad * cap, d), dtype=x_local.dtype,
                       device=x_local.device)
    send = send.index_add(0, slot, torch.where(keep[:, None], tok, 0))

    # rank j of the EP group receives its experts' slots from every sender
    recv = all_to_all(send.reshape(tp_size, El * cap, d), ep)
    recv = recv.reshape(tp_size, El, cap, d).movedim(1, 0).reshape(
        El, tp_size * cap, d)
    y = _expert_ffn(act, recv, w_gate, w_up, w_down)        # (El, tp*cap, d)

    # route back, into the sender's slot layout
    y = y.reshape(El, tp_size, cap, d).movedim(1, 0).reshape(
        tp_size, El * cap, d)
    back = all_to_all(y, ep).reshape(E_pad * cap, d)

    # combine: each assignment's slot, weighted by its gate (0 if dropped)
    yk = back[slot] * torch.where(keep, gat, 0.0)[:, None]
    out = torch.sum(yk.reshape(Tl, k, d), dim=1)
    counts = onehot[:, :mo.num_experts].sum(dim=0)
    aux = _balance(mo.num_experts, torch.softmax(logits, dim=-1), counts,
                   eid.numel())
    return out, aux


def _local_experts(w, spec, ep, E_pad, mesh):
    """This rank's experts of a stacked expert weight (E, ., .), whole:
    its own block where the leaf is expert-sharded over the EP axes, else
    the full leaf padded to E_pad and cut."""
    ep_entry = entry(ep)
    w = materialize(w, spec, keep=0, keep_entry=ep_entry)
    if spec[0] == ep_entry:
        return w
    El = E_pad // mesh.group_size(ep)
    if E_pad != w.shape[0]:
        w = torch.cat([w, w.new_zeros((E_pad - w.shape[0], *w.shape[1:]))])
    i = mesh.index(ep)
    return w[i * El:(i + 1) * El]


def routed_ep(cfg, p, x_local, mesh, ps):
    """Expert-parallel routed experts for this rank's tokens x_local
    (Tl, d) -> (out (Tl, d), aux). ``p``: this rank's slices of the MoE
    leaves, laid out by ``ps`` (their specs). The all_to_all runs along
    the EP axes ('model' by default, ('model', 'data') under the
    ep_all_axes flag); aux is averaged over 'model' and the batch axes,
    as the reference's pmean."""
    from repro_torch.launch.shard_rules import ep_axes
    act = act_fn(cfg.act)
    ep = ep_axes(mesh)
    tp = mesh.group_size(ep)
    E = cfg.moe.num_experts
    E_pad = -(-E // tp) * tp
    w = {n: _local_experts(p[n], ps[n], ep, E_pad, mesh)
         for n in ("w_gate", "w_up", "w_down")}
    router = materialize(p["router"], ps["router"])
    out, aux = _ep_local(cfg, act, x_local, router, w["w_gate"], w["w_up"],
                         w["w_down"], tp_size=tp, ep=ep)
    over = ("model",) + tuple(a for a in ("pod", "data")
                              if a in mesh.axis_names)
    return out, all_reduce(aux, over) / mesh.group_size(over)


def shared_expert_ffn(cfg, p, x):
    act = act_fn(cfg.act)
    sp = p["shared"]
    return (act(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]


def _moe_ffn_sharded(cfg, p, x, ps, mesh):
    """moe_ffn on this rank's slices: expert parallelism where the mesh's
    'model' axis has more than one rank (the reference's rule), else the
    one-device routed path on the gathered leaves."""
    from repro_torch.launch.shard_rules import batch_axes
    B, S, d = x.shape
    T = B * S
    routed_p = {k: v for k, v in p.items() if k != "shared"}
    routed_s = {k: v for k, v in ps.items() if k != "shared"}
    if "model" in mesh.axis_names and mesh.shape["model"] > 1:
        # the local tokens, padded up to and split over 'model' (unless
        # 'model' already splits the batch, under flat_dp)
        n = 1 if "model" in batch_axes(mesh) else mesh.shape["model"]
        Tp = -(-T // n) * n
        x2d = x.reshape(T, d)
        if Tp != T:
            x2d = torch.cat([x2d, x2d.new_zeros((Tp - T, d))])
        r = mesh.index("model") if n > 1 else 0
        out2d, aux = routed_ep(cfg, routed_p, x2d[r * Tp // n:
                                                   (r + 1) * Tp // n],
                               mesh, routed_s)
        if n > 1:
            out2d = all_gather(out2d, "model", 0)
        out = out2d[:T].reshape(B, S, d)
    else:
        out2d, aux = routed(cfg, materialize_tree(routed_p, routed_s),
                            x.reshape(T, d))
        out = out2d.reshape(B, S, d)
    if cfg.moe.num_shared_experts:
        from repro_torch.models.transformer import ffn_sharded
        out = out + ffn_sharded(cfg, p["shared"], ps["shared"], x)
    return out, aux


def moe_ffn(cfg, p, x, ps=None):
    """x (B,S,d) -> (out, aux_loss): the routed experts plus the shared
    ones. ``ps``: the leaves' specs, under an active mesh (``p`` then
    holds this rank's slices)."""
    mesh = active_mesh()
    if mesh is not None:
        return _moe_ffn_sharded(cfg, p, x, ps, mesh)
    B, S, d = x.shape
    out2d, aux = routed(cfg, p, x.reshape(B * S, d))
    out = out2d.reshape(B, S, d)
    if cfg.moe.num_shared_experts:
        out = out + shared_expert_ffn(cfg, p, x)
    return out, aux
