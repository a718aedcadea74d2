"""The port's sharding rules (repro_torch.launch.shard_rules) against the
reference's (repro.launch.shard_rules) on every leaf of every registered
configuration's params, on meshes (16, 16), (2, 16, 16), (4, 2), (2, 4)
and (1, 1), with no flag and under each of resident_weights, flat_dp,
tp2d and ep_all_axes; the same for ``data_spec`` and ``batch_axes``; the
port's ``cache_spec`` against its documented rule; and the local slices
that ``shard_tree`` cuts.

The reference's rules read only a mesh's ``axis_names`` and ``shape``
(``_translate``), so they are called with a stub that has those two and
no JAX device. A ``PartitionSpec`` is a tuple whose one-name tuples read
as the name, which is the port's spec type."""
import itertools

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


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "none")
def test_cache_spec_follows_documented_rule(flags):
    """k / v: batch over the batch axes where it divides; KV heads over
    'model' exactly where the layer is head-parallel (tp divides K or K
    divides tp, whole query heads per rank, no flat_dp / tp2d); every
    other cache array whole on each model rank."""
    _flags(flags)
    for shape, axes in MESHES:
        mesh = abstract_mesh(shape, axes)
        dp = 1
        for a in sr.batch_axes(mesh):
            dp *= mesh.shape[a]
        tp = mesh.shape["model"]
        for arch in ARCHS:
            cfg = tget_config(arch)
            hp = sr.head_parallel(cfg, mesh)
            H, K = cfg.num_heads, cfg.num_kv_heads
            assert hp == (cfg.attention_kind != "mla" and H % tp == 0 and
                          (K % tp == 0 or tp % K == 0) and not any(
                              f in flags for f in ("flat_dp", "tp2d")))
            for B in (1, 8, 128):
                bspec = tuple(sr.batch_axes(mesh)) if B % dp == 0 else ()
                kv = sr.cache_spec("k", (2, B, 64, K, 64), mesh, batch=B,
                                   head_parallel=hp)
                assert entry_axes(kv[1]) == bspec
                assert kv[3] == ("model" if hp else None)
                assert kv[0] is kv[2] is kv[4] is None
                for name, rank in (("state", 5), ("ssm_h", 4),
                                   ("ckv", 4), ("sx_tm", 3)):
                    cs = sr.cache_spec(name, (2, B) + (4,) * (rank - 2),
                                       mesh, batch=B, head_parallel=hp)
                    assert entry_axes(cs[1]) == bspec
                    assert all(e is None for i, e in enumerate(cs)
                               if i != 1)


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
