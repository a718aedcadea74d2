"""The port's model layer (repro_torch.models, serving.kv_cache) against
the reference package on the same weights (converted by repro_torch.bridge)
and the same numpy-seeded inputs.

Logit tolerance: 1e-4 (absolute and relative) in float32. Both sides
compute in float32, but XLA and PyTorch sum the projections in different
orders (~1e-7 relative per product); through a few layers that stays near
1e-5 on logits of order 1. Cached calls are held at 1e-4 with float32
K/V buffers on both sides (the point is the algorithm). With the engines'
bfloat16 K/V they are held at 5e-3: a last-bit float32 difference in a
K/V projection can round to a neighbouring bfloat16 value (0.4% of that
element), which moves the logits by up to ~1e-3."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import encoder as jenc  # noqa: E402
from repro.models.transformer import apply_model as japply  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro.serving import kv_cache as jkvc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import encoder as tenc  # noqa: E402
from repro_torch.models.transformer import apply_model as tapply  # noqa: E402
from repro_torch.models.transformer import init_params as tinit  # noqa: E402
from repro_torch.serving import kv_cache as tkvc  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = {"float32": LOGIT_TOL, "bfloat16": dict(rtol=5e-3, atol=5e-3)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(name, seed=0):
    cfg = get_config(name)
    jp = jinit(cfg, jax.random.key(seed))
    tp = bridge.decoder_params(_np_tree(jp), tget_config(name), "cpu")
    return cfg, tget_config(name), jp, tp


def _caches(cfg, tcfg, B, max_len, dtype, chunk=256):
    """The reference's and the port's empty caches, K/V in ``dtype``."""
    jc = jkvc.init_cache(cfg, B, max_len, chunk=chunk)
    tc = tkvc.init_cache(tcfg, B, max_len, chunk=chunk, device="cpu")
    if dtype == "float32":
        jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
        tc = {"stages": [[{k: v.float() for k, v in el.items()}
                          for el in st] for st in tc["stages"]]}
    return jc, tc


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


# ---------------------------------------------------------------------------
# shared ops

def test_rms_norm_matches():
    rs = np.random.RandomState(0)
    x = rs.standard_normal((3, 5, 64)).astype(np.float32) * 3
    s = rs.standard_normal((64,)).astype(np.float32) * 0.1
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5),
           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,pos_shape", [((2, 7, 4, 64), (7,)),
                                             ((2, 7, 4, 64), (2, 7)),
                                             ((2, 7, 32), (2, 7))])
@pytest.mark.parametrize("kind", ["neox", "half", "none"])
def test_apply_rope_matches(shape, pos_shape, kind):
    rs = np.random.RandomState(1)
    x = rs.standard_normal(shape).astype(np.float32)
    pos = rs.randint(0, 500, pos_shape).astype(np.int32)
    _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              10000.0, kind),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                              kind),
           rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_act_fn_matches(name):
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    _close(tcommon.act_fn(name)(torch.from_numpy(x)),
           jcommon.act_fn(name)(jnp.asarray(x)), rtol=1e-6, atol=1e-6)


def test_softcap_matches():
    x = np.linspace(-200, 200, 101).astype(np.float32)
    _close(tcommon.softcap(torch.from_numpy(x), 30.0),
           jcommon.softcap(jnp.asarray(x), 30.0), rtol=1e-6, atol=1e-5)
    assert tcommon.softcap(torch.from_numpy(x), None) is not None


# ---------------------------------------------------------------------------
# decoder

@pytest.mark.parametrize("name", ["tiny-core-llm", "tiny-lite-llm"])
def test_port_init_params_shapes_match_reference(name):
    jp = jinit(get_config(name), jax.random.key(0))
    tp = tinit(tget_config(name), torch.Generator().manual_seed(0),
               torch.float32, "cpu")
    jl, jdef = jax.tree.flatten(_np_tree(jp))
    tl = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tp,
                                      is_leaf=torch.is_tensor))
    assert [a.shape for a in jl] == [b.shape for b in tl]
    # same scales: embed std 0.02, dense std 1/sqrt(fan_in)
    assert abs(float(tp["embed"].std()) - 0.02) < 2e-3
    wq = tp["stages"][0][0]["attn"]["wq"]
    assert abs(float(wq.std()) * wq.shape[1] ** 0.5 - 1.0) < 0.05


def test_bridge_rejects_mismatched_trees():
    cfg = get_config("tiny-core-llm")
    tree = _np_tree(jinit(cfg, jax.random.key(0)))
    with pytest.raises(ValueError):
        bridge.decoder_params(tree, tget_config("tiny-lite-llm"), "cpu")
    tree["stages"][0][0]["ln1"] = tree["stages"][0][0]["ln1"][0]
    with pytest.raises(ValueError):
        bridge.decoder_params(tree, tget_config("tiny-core-llm"), "cpu")


@pytest.mark.parametrize("name", ["tiny-core-llm", "tiny-lite-llm"])
def test_train_call_logits_match(name):
    cfg, tcfg, jp, tp = _params(name)
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 80))
    jl, _, _ = japply(cfg, jp, jnp.asarray(toks))
    tl, cache = tapply(tcfg, tp, torch.from_numpy(toks))
    assert cache is None
    _close(tl, jl, **LOGIT_TOL)


@pytest.mark.parametrize("name", ["tiny-core-llm", "tiny-lite-llm"])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_prefill_on_prefix_and_decode_logits_match(name, kv_dtype):
    """Prefill, Pass-3 partial prefill on the resident prefix, then decode
    steps, with per-sequence positions, through a cache sized so that the
    lite model's 64-token window ring (256 slots) wraps."""
    cfg, tcfg, jp, tp = _params(name, seed=3)
    B, max_len = 2, 512
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (B, 300))
    start = np.array([0, 5], np.int32)
    jc, tc = _caches(cfg, tcfg, B, max_len, kv_dtype, chunk=64)
    if name == "tiny-lite-llm":
        assert tc["stages"][0][0]["k"].shape[2] == 256     # ring
    steps = [(0, 200), (200, 264), (264, 265), (265, 266), (266, 267)]
    for lo, hi in steps:
        pos = start + lo
        jl, jc, _ = japply(cfg, jp, jnp.asarray(toks[:, lo:hi]), jc,
                           jnp.asarray(pos))
        tl, tc = tapply(tcfg, tp, torch.from_numpy(toks[:, lo:hi]), tc,
                        torch.from_numpy(pos))
        _close(tl, jl, **CACHE_TOL[kv_dtype])


@pytest.mark.parametrize("kw", [{"logits_slice": 1},
                                {"logits_at": np.array([3, 9], np.int32)}])
def test_logits_slice_and_at_match(kw):
    cfg, tcfg, jp, tp = _params("tiny-core-llm")
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 16))
    jc, tc = _caches(cfg, tcfg, 2, 64, "float32")
    jl, _, _ = japply(cfg, jp, jnp.asarray(toks), jc, 0, **kw)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tl, _ = tapply(tcfg, tp, torch.from_numpy(toks), tc, 0, **tkw)
    assert tuple(tl.shape) == (2, 1, cfg.vocab_size)
    _close(tl, jl, **LOGIT_TOL)


def test_write_linear_clamp_matches_reference():
    """A bucketed chunk that would run past the cache end: the reference's
    dynamic_update_slice clamps the start to T-S, over live prefix slots
    (the suspected fault recorded in ROADMAP.md Queue 3). The port
    reproduces it: same cache contents and same logits."""
    cfg, tcfg, jp, tp = _params("tiny-core-llm", seed=6)
    T, P, S = 64, 40, 32                       # P + S > T: clamps to 32
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (1, P + S))
    jc, tc = _caches(cfg, tcfg, 1, T, "float32")
    for lo, hi in ((0, P), (P, P + S)):
        jl, jc, _ = japply(cfg, jp, jnp.asarray(toks[:, lo:hi]), jc, lo)
        tl, tc = tapply(tcfg, tp, torch.from_numpy(toks[:, lo:hi]), tc, lo)
        _close(tl, jl, **LOGIT_TOL)
    jk = np.asarray(jc["stages"][0][0]["k"], np.float32)
    tk = tc["stages"][0][0]["k"].float().numpy()
    np.testing.assert_allclose(tk, jk, rtol=1e-5, atol=1e-5)
    # the second write landed at T-S = 32, not at P = 40: slots 32..39 of
    # the prefix were overwritten, slots 64.. do not exist
    buf = torch.zeros((1, T, 1), dtype=torch.float32)
    tkvc.write_linear(buf, torch.ones((1, S, 1)), P)
    assert buf[0, :T - S].sum() == 0 and buf[0, T - S:].sum() == S


def test_write_ring_and_slot_positions_match():
    rs = np.random.RandomState(8)
    buf = rs.standard_normal((2, 16, 3)).astype(np.float32)
    ch = rs.standard_normal((2, 5, 3)).astype(np.float32)
    pos = np.array([3, 14], np.int32)
    _close(tkvc.write_ring(torch.from_numpy(buf.copy()), torch.from_numpy(ch),
                           torch.from_numpy(pos)),
           jkvc.write_ring(jnp.asarray(buf), jnp.asarray(ch),
                           jnp.asarray(pos)), rtol=0, atol=0)
    length = np.array([0, 7, 40], np.int32)
    for t_fn, j_fn in ((tkvc.slot_positions_ring, jkvc.slot_positions_ring),
                       (tkvc.slot_positions_linear,
                        jkvc.slot_positions_linear)):
        np.testing.assert_array_equal(
            t_fn(16, torch.from_numpy(length)).numpy(),
            np.asarray(j_fn(16, jnp.asarray(length))))


@pytest.mark.parametrize("name", ["tiny-core-llm", "tiny-lite-llm"])
def test_cache_shapes_and_bytes_match(name):
    cfg, tcfg = get_config(name), tget_config(name)
    jc = jkvc.init_cache(cfg, 2, 512, chunk=128)
    tc = tkvc.init_cache(tcfg, 2, 512, chunk=128, device="cpu")
    tleaves = jax.tree.leaves(tc, is_leaf=torch.is_tensor)
    assert [tuple(a.shape) for a in jax.tree.leaves(jc)] == \
        [tuple(a.shape) for a in tleaves]
    assert all(a.dtype == torch.bfloat16 for a in tleaves)
    assert tkvc.bytes_per_token(tcfg) == jkvc.bytes_per_token(cfg)


# ---------------------------------------------------------------------------
# encoder

@pytest.mark.parametrize("enc", ["EMBEDDER", "RERANKER"])
def test_encoder_matches(enc):
    jcfg, tcfg = getattr(jenc, enc), getattr(tenc, enc)
    jp = jenc.init_encoder_params(jcfg, jax.random.key(0))
    tp = bridge.encoder_params(_np_tree(jp), tcfg, "cpu")
    rs = np.random.RandomState(9)
    toks = rs.randint(0, jcfg.vocab_size, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.float32)
    mask[1, 9:] = 0
    mask[2, 3:] = 0
    j = jenc.apply_encoder(jcfg, jp, jnp.asarray(toks), jnp.asarray(mask))
    t = tenc.apply_encoder(tcfg, tp, torch.from_numpy(toks),
                           torch.from_numpy(mask))
    _close(t, j, rtol=1e-5, atol=1e-5)
