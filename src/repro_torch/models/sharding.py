"""The mesh context, partition specs and the collectives of the sharded
path (PyTorch counterpart of ``repro/models/sharding.py``).

The reference annotates activations with ``hint`` and lets GSPMD insert
the collectives. The port shards explicitly: under ``mesh_context(mesh)``
each process holds its own slice of every param (``launch/shard_rules.py::
shard_tree``) and the model code gathers, reduces and exchanges through
the four functions here, the only doors through which the sharded path
talks across ranks: ``all_gather``, ``all_reduce``, ``reduce_scatter`` and
``all_to_all``. Each takes a mesh axis name or a tuple of names, is a
no-op over a group of one rank, and adds the bytes of its result tensor
to ``COUNTER`` under the reference's type names ("all-gather", ...): the
quantity the reference's HLO parser counts. The port runs eagerly, so a
collective is counted each time it is issued, backward ones included.

Under autograd each is the exact adjoint of its forward in the view
where every rank's tensors are separate variables: the gather's backward
is a reduce-scatter (sum), the all-reduce's an all-reduce, the
all_to_all's the reverse all_to_all. So the gradient of a param held
identically by several ranks is the sum of their gradients
(``training/train_step.py`` adds them over the axes the param is
replicated on), whatever the ranks computed.

A partition spec is a tuple with one entry per dim: None, an axis name,
or a tuple of axis names (the values of the reference's
``PartitionSpec``, a one-name tuple written as the name). A dim of n
elements split over a group of g ranks holds n/g elements per rank, the
rank's block in mesh order (``launch/mesh.py``); where instead g is a
multiple of n (a KV head read by several ranks' query heads) each rank
holds one element, the (index * n // g)-th.

``merge_partials`` combines attention partials over a sequence-split
cache (``launch/shard_rules.py::cache_spec``) by their log-sum-exps.

Logical axes of ``logical_to_spec``:
  'batch'  -> all batch-ish mesh axes present: ('pod', 'data')
  'model'  -> tensor-parallel axis 'model'
  None     -> unsharded
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

_state = threading.local()


def _axes():
    return getattr(_state, "axes", None)


def _mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Run the model code inside this block on ``mesh``'s shards."""
    prev_axes, prev_mesh = _axes(), _mesh()
    _state.axes = tuple(mesh.axis_names)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.axes = prev_axes
        _state.mesh = prev_mesh


def active_mesh():
    return _mesh()


def axis_present(name: str) -> bool:
    axes = _axes()
    return axes is not None and name in axes


def entry(group):
    """A spec entry for a tuple of axis names: None, the name, or the
    tuple."""
    group = tuple(group)
    if not group:
        return None
    return group[0] if len(group) == 1 else group


def entry_axes(e) -> tuple:
    """The axis names of a spec entry."""
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def logical_to_spec(logical, axes=None) -> tuple:
    from repro_torch.launch import optflags
    axes = axes if axes is not None else _axes()
    parts = []
    for lg in logical:
        if lg is None or axes is None:
            parts.append(None)
        elif lg == "batch":
            names = (("pod", "data", "model")
                     if optflags.has("flat_dp") else ("pod", "data"))
            parts.append(entry(a for a in names if a in axes))
        elif lg == "model":
            if optflags.has("flat_dp"):    # model axis belongs to batch
                parts.append(None)
            else:
                parts.append("model" if "model" in axes else None)
        else:
            raise ValueError(f"unknown logical axis {lg!r}")
    return tuple(parts)


def hint(x, *logical):
    """The reference's sharding constraint. The port shards explicitly,
    so this is the identity."""
    return x


# ---------------------------------------------------------------------------
# local slices

def dim_slice(n: int, g: int, i: int):
    """The elements of a dim of ``n`` that rank ``i`` of ``g`` holds."""
    if n % g == 0:
        return slice(i * (n // g), (i + 1) * (n // g))
    if g % n == 0:
        j = i * n // g
        return slice(j, j + 1)
    raise ValueError(f"a dim of {n} does not split over {g} ranks")


def local_shape(shape, spec, mesh) -> tuple:
    out = []
    for n, e in zip(shape, spec):
        g = mesh.group_size(entry_axes(e)) if e is not None else 1
        s = dim_slice(n, g, 0)
        out.append(s.stop - s.start)
    return tuple(out)


def local_slice(x, spec, mesh, rank=None):
    """The block of the full tensor ``x`` that ``rank`` holds under
    ``spec`` (a view)."""
    idx = []
    for n, e in zip(x.shape, spec):
        axes = entry_axes(e)
        if not axes:
            idx.append(slice(None))
            continue
        idx.append(dim_slice(n, mesh.group_size(axes),
                             mesh.index(axes, rank)))
    return x[tuple(idx)]


# ---------------------------------------------------------------------------
# collectives

class CollectiveCounter:
    """Bytes of the results of the collectives issued, by type."""

    def __init__(self):
        self.bytes = {}

    def reset(self):
        self.bytes = {}

    def add(self, kind: str, t: torch.Tensor):
        self.bytes[kind] = self.bytes.get(kind, 0) + \
            t.numel() * t.element_size()

    def total(self) -> int:
        return sum(self.bytes.values())


COUNTER = CollectiveCounter()

# the unsuffixed names are deprecated from torch 2.12 on
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_from = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _group(axes):
    mesh = _mesh()
    if mesh is None:
        raise RuntimeError("a collective outside mesh_context")
    return mesh, mesh.group_size(axes)


def _gather(x, axes, dim):
    mesh, n = _group(axes)
    x0 = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x0.shape[0], *x0.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _gather_into(out, x0, group=mesh.group(axes))
    COUNTER.add("all-gather", out)
    return out.movedim(0, dim)


def _scatter(x, axes, dim):
    mesh, n = _group(axes)
    x0 = x.movedim(dim, 0).contiguous()
    out = torch.empty((x0.shape[0] // n, *x0.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _scatter_from(out, x0, group=mesh.group(axes))
    COUNTER.add("reduce-scatter", out)
    return out.movedim(0, dim)


def _reduce(x, axes):
    mesh, _ = _group(axes)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.group(axes))
    COUNTER.add("all-reduce", out)
    return out


def _exchange(x, axes):
    mesh, _ = _group(axes)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(axes))
    COUNTER.add("all-to-all", out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return _gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.axes, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return _scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axes, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.axes), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _exchange(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axes), None


def _trivial(axes) -> bool:
    mesh = _mesh()
    return mesh is not None and mesh.group_size(axes) == 1


def all_gather(x, axes, dim: int = 0):
    """Concatenate the group's ``x`` along ``dim``, in group order."""
    axes = entry_axes(axes)
    return x if _trivial(axes) else _AllGather.apply(x, axes, dim % x.dim())


def reduce_scatter(x, axes, dim: int = 0):
    """Sum the group's ``x`` and keep this rank's block of ``dim``."""
    axes = entry_axes(axes)
    return x if _trivial(axes) else \
        _ReduceScatter.apply(x, axes, dim % x.dim())


def all_reduce(x, axes):
    """Sum of the group's ``x``."""
    axes = entry_axes(axes)
    return x if _trivial(axes) else _AllReduce.apply(x, axes)


def all_to_all(x, axes):
    """Block j of dim 0 goes to group rank j; block i of the result came
    from group rank i."""
    axes = entry_axes(axes)
    return x if _trivial(axes) else _AllToAll.apply(x, axes)


def merge_partials(o, lse, axes):
    """Attention over a sequence split across the group ``axes``, from
    each rank's partial over its own keys: ``o`` (..., hd) normalised over
    those keys and ``lse`` (...) float32 their log-sum-exp (-inf where the
    rank holds none of a row's keys). The LSEs are all-gathered, each
    rank weights its o by exp(lse - lse_total), and the weighted partials
    are all-reduced: two collectives, both counted. Returns o's merge in
    o's dtype (0 for a row that no rank's keys reach)."""
    axes = entry_axes(axes)
    if _trivial(axes) or not axes:
        return o
    lses = all_gather(lse[None], axes, 0)               # (n, ...)
    m = lses.amax(0)
    m = torch.where(torch.isfinite(m), m, 0.0)
    total = torch.exp(lses - m).sum(0)
    w = torch.where(total > 0, torch.exp(lse - m) / total, 0.0)
    return all_reduce(o.float() * w[..., None], axes).to(o.dtype)


def materialize(x, spec, keep=None, keep_entry="model"):
    """This rank's shard ``x`` of a leaf laid out by ``spec``, gathered
    over every sharded dim except ``keep``, which stays local where its
    entry is exactly ``keep_entry`` (the tensor-parallel layout; the
    experts' EP layout). Gathered tensors are transient: ZeRO-3 use of an
    FSDP-sharded weight."""
    for d, e in enumerate(spec):
        if e is None or (d == keep and e == keep_entry):
            continue
        x = all_gather(x, e, d)
    return x


def model_block(x, spec, dim, mesh):
    """This rank's block over 'model' of dim ``dim`` of a leaf (rank i of
    tp holds the i-th of tp equal blocks): its local shard where ``spec``
    splits that dim over exactly 'model', else cut from the gathered leaf
    (a replicated leaf, or one whose rule names another axis there). Every
    other sharded dim is gathered."""
    x = materialize(x, spec, keep=dim)
    if spec[dim] == "model":
        return x
    return x.narrow(dim, *model_span(x.shape[dim], mesh))


def model_span(n, mesh):
    """(start, length) of this rank's 'model' block of a dim of n."""
    s = dim_slice(n, mesh.shape["model"], mesh.index("model"))
    return s.start, s.stop - s.start


def materialize_tree(tree, specs):
    """``materialize`` over every leaf of a params subtree."""
    if isinstance(tree, dict):
        return {k: materialize_tree(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [materialize_tree(v, s) for v, s in zip(tree, specs)]
    return materialize(tree, specs)
