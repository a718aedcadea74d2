"""Device meshes over ``torch.distributed`` (PyTorch counterpart of
``repro/launch/mesh.py``), and the H100's roofline constants.

Single pod:  (16, 16)      axes ('data', 'model')          — 256 ranks
Multi pod:   (2, 16, 16)   axes ('pod', 'data', 'model')   — 512 ranks

The mesh builders are FUNCTIONS, not module constants, so importing never
touches a process group. They need the default group to be initialised
with a world size equal to the mesh's size (the dry run opens a fake one;
the tests open gloo ranks; a card opens NCCL).

A ``Mesh`` is what the sharding rules and the sharded model code read:
``axis_names``, ``shape`` (axis -> size, as ``jax.sharding.Mesh.shape``),
this process's coordinates, and the process group of any set of axes.
It holds the ``torch.distributed.device_mesh.DeviceMesh`` it was built
over (``device_mesh``). Ranks are laid out row-major over the axes, as
``init_device_mesh`` lays them out. A set of several axes is ordered as
the mesh orders them, so the rank of a process in such a group (and the
shard it holds of a dim split over those axes) is its row-major index
over them in mesh order, whatever order a spec lists them in.
"""
from __future__ import annotations

import math

import torch.distributed as dist

# H100 SXM published peaks (NVIDIA H100 Tensor Core GPU data sheet, SXM5
# column, dense rates without sparsity, at the 700 W limit)
PEAK_FLOPS_BF16 = 989e12        # bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12         # fp32 SIMT (the port's fp32 matmuls, TF32 off)
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s per direction (NVLink 4: 900 GB/s)
HBM_BYTES = 80 * 10 ** 9        # 80 GB


class Mesh:
    """Named axes over ranks ``0 .. size-1``. ``device_mesh`` is None for
    a mesh that only describes a layout (shape arithmetic, tests)."""

    def __init__(self, shape, axis_names, device_mesh=None, rank=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)
        self.device_mesh = device_mesh
        if rank is None:
            rank = dist.get_rank() if device_mesh is not None else 0
        self.rank = rank
        self._groups = {}

    def coords(self, rank=None) -> dict:
        """Axis -> index of ``rank`` (default: this process)."""
        r = self.rank if rank is None else rank
        out = {}
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return out

    def ordered(self, axes) -> tuple:
        """``axes`` (a name or names) in mesh order, absent ones dropped."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.ordered(axes))

    def index(self, axes, rank=None) -> int:
        """Row-major index of ``rank`` over ``axes`` in mesh order: its
        rank in the group of those axes."""
        c = self.coords(rank)
        i = 0
        for a in self.ordered(axes):
            i = i * self.shape[a] + c[a]
        return i

    def group(self, axes):
        """The process group of this rank over ``axes`` (every rank that
        shares this rank's coordinates on the other axes). A group of
        several axes is made on first use, by every rank together, so the
        sharded code must ask for the same groups in the same order on
        every rank (SPMD code does)."""
        axes = self.ordered(axes)
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = self.device_mesh.get_group(axes[0])
            else:
                self._groups[axes] = dist.new_subgroups_by_enumeration(
                    self._partition(axes))[0]
        return self._groups[axes]

    def _partition(self, axes):
        """Every group of ``axes``: lists of ranks in group-rank order."""
        groups = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            groups.setdefault(key, []).append(r)
        return [groups[k] for k in sorted(groups)]


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _build(shape, axes) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"default group has {dist.get_world_size()}")
    dm = init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=axes)
    return Mesh(shape, axes, dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _build(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Small ('data', 'model') mesh over the default group's ranks — used
    by the distributed correctness tests and the card's world-size-1
    check."""
    return _build((data, model), ("data", "model"))


def abstract_mesh(shape, axes) -> Mesh:
    """A layout-only mesh (no process group): rank 0's view."""
    return Mesh(tuple(shape), tuple(axes), None, 0)

