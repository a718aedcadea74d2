"""Parameter, cache and batch partition specs, and each rank's slices
(PyTorch counterpart of ``repro/launch/shard_rules.py``).

Logical layout:
  - 'fsdp' -> 'data'   (weights/optimizer sharded over the data axis,
                        all-gathered at use — ZeRO-3 style)
  - 'tp'   -> 'model'  (tensor parallel: head/ffn/vocab dims)
  - batch  -> ('pod', 'data')
Expert weights are expert-sharded over the EP axes + FSDP over 'data' on
the d axis (``models/moe.py::routed_ep`` reads them so).

An axis is only sharded when the dim divides by the mesh axes' size.
Specs are the port's spec type (``models/sharding.py``): tuples of None,
an axis name, or a tuple of axis names, with the values of the
reference's ``PartitionSpec`` for every param, optimizer and batch leaf.

``cache_spec`` gives the reference's cache layout (the sequence over
'model'); its docstring says what the port does where the reference
names one axis on two dims. ``shard_tree`` cuts each rank's slices out of
a full tree.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.launch import optflags
from repro_torch.models.sharding import entry, entry_axes, local_slice

# last-path-component name -> logical spec for the UNSTACKED param
_RULES = {
    # embeddings / head. The table is vocab-sharded over 'model' only
    # (a vocab-parallel lookup: mask + all-reduce); a tied head then
    # gives vocab-parallel logits.
    "embed": ("tp", None),
    "pos_embed": (None, None),
    "lm_head": ("fsdp", "tp"),
    # attention
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    # mla
    "wq_a": ("fsdp", "tp"),
    "wq_b": ("fsdp", "tp"),
    "wkv_a": ("fsdp", None),
    "wkv_b": ("fsdp", "tp"),
    # dense ffn / shared experts
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # moe (expert-stacked: handled by rank-3 override below)
    "router": (None, None),
    # rwkv
    "wr": ("fsdp", "tp"),
    "mix_w1": ("fsdp", None),
    "mix_w2": (None, None, "tp"),
    "w_w1": ("fsdp", None),
    "w_w2": (None, "tp"),
    # mamba
    "w_in": ("fsdp", "tp"),
    "w_x": ("fsdp", None),
    "w_dt": (None, "tp"),
    "A_log": ("tp", None),
    "conv_w": (None, "tp"),
    "head": (None, None),
    "w1": (None, None), "w2": (None, None),
}

# MoE expert-stacked weights (E, d, f) / (E, f, d)
_MOE_RULES = {
    "w_gate": ("ep", "fsdp", None),
    "w_up": ("ep", "fsdp", None),
    "w_down": ("ep", None, "fsdp"),
}


def ep_axes(mesh):
    """Expert-parallel axes: 'model' by default; ('model','data') under
    the ep_all_axes opt flag (experts fully resident, DeepSeek-style
    wide EP)."""
    if optflags.has("ep_all_axes"):
        return tuple(a for a in ("model", "data") if a in mesh.axis_names)
    return ("model",) if "model" in mesh.axis_names else ()


def fsdp_axes(mesh):
    """FSDP spans the data axis, extended across pods when present. With
    the 'resident_weights' opt flag, FSDP is disabled: weights stay
    resident (TP-sharded only) instead of being re-gathered per use."""
    if optflags.has("resident_weights"):
        return ()
    return tuple(a for a in ("data", "pod") if a in mesh.axis_names)


def _translate(logical, axes, shape, mesh):
    parts = []
    for lg, dim in zip(logical, shape):
        if lg is None:
            parts.append(None)
            continue
        if optflags.has("flat_dp"):
            # pure DP: weights FSDP-shard one dim over every axis, no
            # tensor parallelism ('tp'/'ep' dims stay unsharded)
            group = (tuple(a for a in ("data", "model", "pod")
                           if a in axes) if lg == "fsdp" else ())
        elif lg == "fsdp":
            group = fsdp_axes(mesh)
        elif lg == "ep":
            group = ep_axes(mesh)
        elif optflags.has("tp2d"):
            # 2-D resident tensor parallelism: TP dims shard over BOTH
            # axes (weights never re-gathered; small activations move)
            group = tuple(a for a in ("model", "data") if a in axes)
        else:
            group = ("model",)
        group = tuple(a for a in group if a in axes)
        n = math.prod(mesh.shape[a] for a in group)
        parts.append(entry(group) if group and dim % n == 0 else None)
    return tuple(parts)


def param_spec(path, shape, mesh) -> tuple:
    """path: the leaf's keys from the root (dict keys, list indices)."""
    keys = list(path)
    name = next((k for k in reversed(keys) if isinstance(k, str)), None)
    in_moe = "moe" in keys
    rank = len(shape)

    if name in ("m", "v", "step"):
        # optimizer moments mirror their parameter (path continues past m/v)
        name = next((k for k in reversed(keys[:keys.index(name)])
                     if isinstance(k, str)), name)

    if in_moe and name in _MOE_RULES and rank >= 3:
        logical = _MOE_RULES[name]
    elif name in _RULES:
        logical = _RULES[name]
    else:
        logical = ()

    logical = tuple(logical[-rank:]) if logical else ()
    if len(logical) < rank:  # stacked leading dims (stage repeat) -> None
        logical = (None,) * (rank - len(logical)) + logical
    return _translate(logical, mesh.axis_names, shape, mesh)


def _with_paths(tree, fn, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (a spec, itself a
    tuple, is a leaf)."""
    if isinstance(tree, dict):
        return {k: _with_paths(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_paths(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_specs(tree, mesh):
    """The spec of every leaf of a params / optimizer-state tree of FULL
    tensors (meta tensors will do)."""
    return _with_paths(tree, lambda p, t: param_spec(p, t.shape, mesh))


@functools.lru_cache(maxsize=32)
def _model_specs(cfg, axis_names, sizes, flags):
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.transformer import param_shapes
    return tree_specs(param_shapes(cfg), abstract_mesh(sizes, axis_names))


def model_specs(cfg, mesh):
    """The spec tree of ``cfg``'s params on ``mesh`` under the active
    flags (computed once per combination)."""
    return _model_specs(cfg, tuple(mesh.axis_names),
                        tuple(mesh.shape[a] for a in mesh.axis_names),
                        frozenset(optflags.ACTIVE))


def shard_tree(tree, mesh, rank=None, specs=None):
    """Rank ``rank``'s (default: this process's) slice of every leaf of a
    full tree, as contiguous tensors of its own (meta in, meta out)."""
    specs = tree_specs(tree, mesh) if specs is None else specs

    def cut(path, t):
        sp = specs
        for k in path:
            sp = sp[k]
        return local_slice(t, sp, mesh, rank).clone()
    return _with_paths(tree, cut)


# ---------------------------------------------------------------------------
# KV cache / activations

def batch_axes(mesh):
    """Batch shards over (pod, data); under the flat_dp opt flag the
    'model' axis joins them (pure data parallelism)."""
    axes = ("pod", "data", "model") if optflags.has("flat_dp") \
        else ("pod", "data")
    return tuple(a for a in axes if a in mesh.axis_names)


def head_parallel(cfg, mesh) -> bool:
    """Whether a GQA layer's no-cache forward (training, a prefill without
    a cache) computes its query heads split over 'model': wq / wo split
    by whole heads there, and each rank's query heads read a KV-head set
    it can hold (K % tp == 0, or tp % K == 0). Otherwise every rank
    computes all heads."""
    if "model" not in mesh.axis_names or optflags.has("flat_dp") or \
            optflags.has("tp2d") or cfg.attention_kind == "mla":
        return False
    tp = mesh.shape["model"]
    H, K = cfg.num_heads, cfg.num_kv_heads
    return H % tp == 0 and (K % tp == 0 or tp % K == 0)


def batch_sharded(mesh, batch: int) -> bool:
    """Whether a cache of ``batch`` sequences shards its batch over
    ``batch_axes`` (the batch divides their size)."""
    return batch % math.prod(mesh.shape[a] for a in batch_axes(mesh)) == 0


def seq_axes(mesh, batch: int):
    """The spec entry of a cache's sequence dim: 'model' (the reference's
    flash-decode layout), or ('data', 'model') when the batch does not
    divide over the batch axes (long_500k, B = 1); None without those
    axes."""
    if batch_sharded(mesh, batch):
        return "model" if "model" in mesh.axis_names else None
    return entry(a for a in ("data", "model") if a in mesh.axis_names)


_CACHE_LEAVES = ("k", "v", "ckv", "krope", "state", "ssm_h", "ssm_conv",
                 "sx_tm", "sx_cm")


def cache_spec(name: str, shape, mesh, *, batch: int) -> tuple:
    """The reference's ``cache_spec``: cache arrays have a leading
    stage-repeat dim; the batch shards over ``batch_axes`` where it
    divides; k / v (R,B,T,K,hd) and MLA's ckv / krope (R,B,T,r) put the
    sequence over ``seq_axes``; RWKV's state (R,B,H,dk,dv) its heads over
    'model' where H divides; the Mamba branch's ssm_h (R,B,dI,N) its dI
    over 'model'; ssm_conv and the token-shift rows are whole beyond the
    batch; any other name whole.

    Where the reference names one mesh axis on two dims, which a layout
    cannot do: under ``flat_dp`` the batch axes include 'model', and when
    the batch divides, the reference also puts 'model' on the sequence of
    k / v / ckv / krope, on the state's heads and on ssm_h's dI. The port
    keeps the batch's use of the axis and leaves the later dim whole
    there (the batch is what ``data_spec`` shards the step's inputs by)."""
    parts = [None] * len(shape)
    if name not in _CACHE_LEAVES:
        return tuple(parts)
    bspec = entry(batch_axes(mesh)) if batch_sharded(mesh, batch) else None
    parts[1] = bspec
    axes = mesh.axis_names
    if name in ("k", "v", "ckv", "krope"):              # (R,B,T,...)
        parts[2] = seq_axes(mesh, batch)
    elif name == "state":                               # (R,B,H,dk,dv)
        if "model" in axes and shape[2] % mesh.shape["model"] == 0:
            parts[2] = "model"
    elif name == "ssm_h":                               # (R,B,dI,N)
        if "model" in axes:
            parts[2] = "model"
    taken = set(entry_axes(bspec))
    for i in range(2, len(parts)):
        if taken & set(entry_axes(parts[i])):
            parts[i] = None
    return tuple(parts)


def data_spec(mesh, shape, *, batch_dim: int = 0) -> tuple:
    ba = batch_axes(mesh)
    parts = [None] * len(shape)
    dp = math.prod(mesh.shape[a] for a in ba)
    if shape[batch_dim] % dp == 0:
        parts[batch_dim] = entry(ba)
    return tuple(parts)


def shard_batch(x: torch.Tensor, mesh, rank=None, batch_dim: int = 0):
    """This rank's rows of a global batch tensor (``data_spec``)."""
    return local_slice(x, data_spec(mesh, x.shape, batch_dim=batch_dim),
                       mesh, rank).contiguous()
