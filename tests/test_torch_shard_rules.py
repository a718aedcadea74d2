"""The port's sharding rules (repro_torch.launch.shard_rules) against the
reference's (repro.launch.shard_rules) on every leaf of every registered
configuration's params, on meshes (16, 16), (2, 16, 16), (4, 2), (2, 4)
and (1, 1), with no flag and under each of resident_weights, flat_dp,
tp2d and ep_all_axes; the same for ``data_spec``, ``batch_axes`` and
``cache_spec``; and the local slices that ``shard_tree`` cuts.

The reference's rules read only a mesh's ``axis_names`` and ``shape``
(``_translate``), so they are called with a stub that has those two and
no JAX device. A ``PartitionSpec`` is a tuple whose one-name tuples read
as the name, which is the port's spec type; the reference's
``cache_spec`` writes a one-axis batch as a one-name tuple, which the
comparison reads so too."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config, list_configs  # noqa: E402
from repro.launch import optflags as joptflags  # noqa: E402
from repro.launch import shard_rules as jsr  # noqa: E402
from repro.models import sharding as jsharding  # noqa: E402
from repro.models.transformer import param_shapes as jparam_shapes  # noqa: E402,E501
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.launch import optflags  # noqa: E402
from repro_torch.launch import shard_rules as sr  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.sharding import entry_axes  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((1, 1), ("data", "model"))]
FLAGS = [[], ["resident_weights"], ["flat_dp"], ["tp2d"], ["ep_all_axes"]]
ARCHS = list_configs()


class StubMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _flags(flags):
    joptflags.set_flags(flags)
    optflags.set_flags(flags)


@pytest.fixture(autouse=True)
def _clean_flags():
    _flags([])
    yield
    _flags([])


def _key(k):
    return getattr(k, "key", getattr(k, "idx", None))


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def trees():
    """Each config's leaves: {path: shape} from both packages."""
    out = {}
    for arch in ARCHS:
        jleaves = jax.tree_util.tree_flatten_with_path(
            jparam_shapes(get_config(arch)))[0]
        ref = {tuple(_key(k) for k in p): tuple(x.shape) for p, x in jleaves}
        port = {p: tuple(t.shape)
                for p, t in _walk(param_shapes(tget_config(arch)))}
        out[arch] = (ref, port)
    return out


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "none")
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference(trees, arch, flags):
    ref, port = trees[arch]
    assert ref == port                  # same paths, same shapes
    _flags(flags)
    n = 0
    for shape, axes in MESHES:
        stub, mesh = StubMesh(shape, axes), abstract_mesh(shape, axes)
        for path, leaf_shape in port.items():
            want = tuple(jsr.param_spec(
                [jax.tree_util.DictKey(k) if isinstance(k, str) else
                 jax.tree_util.SequenceKey(k) for k in path],
                leaf_shape, stub))
            got = sr.param_spec(path, leaf_shape, mesh)
            assert got == want, (arch, shape, flags, path, got, want)
            n += 1
    assert n == 5 * len(port)


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "none")
def test_optimizer_moments_follow_their_param(flags):
    _flags(flags)
    mesh = abstract_mesh((4, 2), ("data", "model"))
    params = param_shapes(tget_config("qwen2-moe-a2.7b").reduced())
    opt = {"step": torch.empty((), device="meta"), "m": params,
           "v": params}
    specs = sr.tree_specs(opt, mesh)
    pspecs = sr.tree_specs(params, mesh)
    assert specs["m"] == pspecs and specs["v"] == pspecs
    assert specs["step"] == ()


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "none")
def test_data_spec_and_batch_axes_match_reference(flags):
    _flags(flags)
    for (shape, axes), (B, S) in itertools.product(
            MESHES, [(1, 7), (2, 5), (8, 16), (32, 3), (256, 4)]):
        stub, mesh = StubMesh(shape, axes), abstract_mesh(shape, axes)
        assert sr.batch_axes(mesh) == jsr.batch_axes(stub)
        for dims in ((B, S), (B, S, 64), (B,)):
            assert sr.data_spec(mesh, dims) == \
                tuple(jsr.data_spec(stub, dims)), (shape, flags, dims)
        assert sr.data_spec(mesh, (S, B), batch_dim=1) == \
            tuple(jsr.data_spec(stub, (S, B), batch_dim=1))


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "none")
def test_logical_to_spec_matches_reference(flags):
    _flags(flags)
    for _, axes in MESHES:
        for logical in itertools.product(("batch", "model", None),
                                         repeat=3):
            assert sharding.logical_to_spec(logical, axes) == tuple(
                jsharding.logical_to_spec(logical, axes)), (axes, logical)
    mesh = abstract_mesh((4, 2), ("data", "model"))
    assert not sharding.axis_present("model")
    with sharding.mesh_context(mesh):
        assert sharding.active_mesh() is mesh
        assert sharding.axis_present("model")
        assert not sharding.axis_present("pod")
        x = torch.ones(2)
        assert sharding.hint(x, "batch") is x
    assert sharding.active_mesh() is None


CACHE_LEAVES = {"k": 5, "v": 5, "ckv": 4, "krope": 4, "state": 5,
                "ssm_h": 4, "ssm_conv": 4, "sx_tm": 3, "sx_cm": 3,
                "other": 2}


def _norm(spec):
    """A spec with one-name tuples read as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _dedup(spec):
    """The reference's spec with an axis the batch dim already names
    dropped from each later dim: what the port's ``cache_spec`` gives
    where the reference names one axis twice (its docstring)."""
    taken = set(entry_axes(spec[1]) if len(spec) > 1 else ())
    return tuple(None if i > 1 and taken & set(entry_axes(e)) else e
                 for i, e in enumerate(spec))


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "none")
def test_cache_spec_matches_reference(flags):
    """The reference's ``cache_spec`` for every cache leaf name, on every
    mesh, at batches that divide over the batch axes and that do not
    (the sequence then over ('data', 'model')), and state head counts
    that divide over 'model' and that do not. Where the reference names
    one axis twice (flat_dp: the batch over ('data', 'model') and the
    sequence, the state's heads or ssm_h's dI over 'model'), the port
    leaves the later dim whole, and nowhere else does it differ."""
    _flags(flags)
    twice = 0
    for shape, axes in MESHES:
        stub, mesh = StubMesh(shape, axes), abstract_mesh(shape, axes)
        for B, H in itertools.product((1, 8, 128, 512), (4, 40, 64)):
            for name, rank in CACHE_LEAVES.items():
                dims = (2, B, H) + (64,) * (rank - 3) if rank > 2 else (2, B)
                want = _norm(jsr.cache_spec(name, dims, stub, batch=B))
                got = sr.cache_spec(name, dims, mesh, batch=B)
                assert got == _dedup(want), (shape, flags, name, B, H, got,
                                             want)
                twice += got != want
    assert (twice > 0) == ("flat_dp" in flags), twice


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "musicgen-medium",
                                  "deepseek-v3-671b", "rwkv6-3b",
                                  "hymba-1.5b", "gemma2-9b"])
def test_cache_local_bytes_match_reference(arch):
    """Rank 0's cache at decode_32k and long_500k (batch 1: the sequence
    over ('data', 'model')) on 16 x 16 and 2 x 16 x 16: every leaf's local
    shape from ``init_cache`` under the mesh equals the reference cache
    array's shape divided as the reference's ``cache_spec`` divides it."""
    from repro.configs.base import INPUT_SHAPES
    from repro.serving import kv_cache as jkvc
    from repro_torch.serving.kv_cache import init_cache
    for (shape, axes), ish in itertools.product(
            MESHES[:2], ("decode_32k", "long_500k")):
        stub, mesh = StubMesh(shape, axes), abstract_mesh(shape, axes)
        B, S = INPUT_SHAPES[ish].global_batch, INPUT_SHAPES[ish].seq_len
        cache = init_cache(tget_config(arch), B, S, chunk=1, device="meta",
                           mesh=mesh)
        cfg = get_config(arch)
        for si, st in enumerate(cfg.stages):
            for ei, spec in enumerate(st.pattern):
                for name, (full, _) in jkvc.elem_cache_shape(
                        cfg, spec, st.repeat, B, S, 1).items():
                    want = tuple(
                        n // (1 if e is None else int(np.prod(
                            [stub.shape[a] for a in entry_axes(e)])))
                        for n, e in zip(full, jsr.cache_spec(
                            name, full, stub, batch=B)))
                    got = tuple(cache["stages"][si][ei][name].shape)
                    assert got == want, (arch, shape, ish, name, got, want)


@pytest.mark.parametrize("shape,axes", MESHES[2:4])
def test_shard_tree_slices_tile_the_leaf(shape, axes):
    """Every rank's slices of a leaf, placed back by their specs, cover it
    exactly once per replica; a (K=2)-head cache dim over 4 model ranks
    gives rank i head i * 2 // 4."""
    mesh = abstract_mesh(shape, axes)
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    for spec in [("data", "model"), ("model", None), (("model", "data"),
                                                      None),
                 (None, ("data", "model")), (None, None)]:
        seen = torch.zeros_like(x)
        for r in range(mesh.size):
            t = sr.shard_tree({"w": x}, mesh, r, {"w": spec})["w"]
            idx = []
            for n, e in zip(x.shape, spec):
                ax = entry_axes(e)
                g = mesh.group_size(ax) if ax else 1
                i = mesh.index(ax, r) if ax else 0
                idx.append(slice(i * (n // g), (i + 1) * (n // g)))
            assert torch.equal(t, x[tuple(idx)])
            seen[tuple(idx)] += 1
        reps = mesh.size
        for e in spec:
            ax = entry_axes(e)
            reps //= mesh.group_size(ax) if ax else 1
        assert torch.equal(seen, torch.full_like(x, reps)), spec
    heads = torch.arange(2)
    mesh = abstract_mesh((1, 4), ("data", "model"))
    got = [int(sr.shard_tree({"k": heads}, mesh, r, {"k": ("model",)})
               ["k"]) for r in range(4)]
    assert got == [0, 0, 1, 1]
