"""Head dim 256 (Gemma-2's) on the port, on the CPU: the plain versions of
K1-K5, the split-KV mirror of K2-K4 (``split_kv_plain``) and the
tensor-core mirror of K1 and K5 (``flash_prefill_split_plain``,
``chunk_prefill_split_plain``: q and P in three bf16 pieces, 64-key
tiles) against the reference's pure-jnp oracles (``repro/kernels/ref.py``)
and its Pallas kernels in interpret mode, on the same numpy-seeded inputs
at H = 4, K = 2; then a reduced Gemma-2 9B kept at hd 256 (its logits,
its dense-cache chunks, and its dense and paged engines' greedy tokens)
against the reference.

Tolerances: fp32 2e-5 and bf16 2e-2 for the kernels (tests/
test_kernels.py's), logits 1e-4 (tests/test_torch_archs.py's). The
hand-written CUDA kernels at hd 256 against these plain versions:
tests/test_torch_cuda.py."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.engines.llm_engine import LLMEngine  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models.transformer import apply_model as japply  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro.serving import kv_cache as jkvc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.engines.llm_engine import LLMEngine as TLLMEngine  # noqa: E402
from repro_torch.kernels import chunk_prefill as tcp  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_prefill as tfp  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models.transformer import apply_model as tapply  # noqa: E402
from repro_torch.serving import kv_cache as tkvc  # noqa: E402

HD = 256
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# (window, cap) cases: none, Gemma-2's local window (cut to the test's
# length) with its logit cap, and a cap alone
WINDOW_CAP = [(None, None), (64, 50.0), (None, 30.0)]


def _inputs(seed, shapes, dtype, bf16_kv=False):
    """numpy draws -> (jax arrays, torch tensors) holding the same values;
    with ``bf16_kv`` every array after the first rounded to bf16 values
    (the engines' cache dtype: exact tensor-core operands)."""
    rs = np.random.RandomState(seed)
    xs = [rs.standard_normal(s).astype(np.float32) for s in shapes]
    if bf16_kv:
        xs[1:] = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                  for x in xs[1:]]
    return ([jnp.asarray(x, JDT[dtype]) for x in xs],
            [torch.from_numpy(x).to(TDT[dtype]) for x in xs])


def _ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _check(o, wants, dtype):
    for w in wants:
        np.testing.assert_allclose(_np(o), _np(w), **TOL[dtype])


def _tables(seed, B, maxblk, nb):
    """Distinct shuffled physical blocks per sequence, block 0 unused."""
    perm = np.random.RandomState(seed).permutation(np.arange(1, nb))
    return perm[: B * maxblk].reshape(B, maxblk)


# ---------------------------------------------------------------------------
# K1 flash_prefill (dense cache, a prefix per sequence)

@functools.lru_cache(maxsize=None)
def _prefill_case(B, Sq, T, prefix, dtype, window, cap, bf16_kv):
    (q, k, v), tin = _inputs(30, [(B, Sq, 4, HD), (B, T, 2, HD),
                                  (B, T, 2, HD)], dtype, bf16_kv)
    kw = dict(prefix_len=prefix, window=window, cap=cap)
    wants = (ref.flash_prefill_ref(q, k, v, **kw),
             ops.flash_prefill(q, k, v, bq=64, bk=64, interpret=True, **kw))
    return tin, kw, wants


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_plain_hd256(dtype, window, cap):
    (tq, tk, tv), kw, wants = _prefill_case(2, 64, 256, 100, dtype, window,
                                            cap, False)
    o = tfp.flash_prefill(tq, tk, tv, **kw)
    assert o.dtype == TDT[dtype] and o.shape == (2, 64, 4, HD)
    _check(o, wants, dtype)


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_split_plain_hd256(dtype, window, cap):
    """The tile kernel's arithmetic (three bf16 pieces of q and P, 64-key
    tiles) over bf16-valued K/V, at fp32's own tolerance."""
    (tq, tk, tv), kw, wants = _prefill_case(2, 64, 256, 100, dtype, window,
                                            cap, True)
    o = tfp.flash_prefill_split_plain(tq, tk, tv, **kw)
    assert o.dtype == TDT[dtype] and o.shape == (2, 64, 4, HD)
    _check(o, wants, dtype)


def test_flash_prefill_split_plain_hd256_per_sequence_prefix():
    """A ragged chunk (Sq 70) at per-sequence prefixes 0 / 37 / 150, window
    64 (the long rows' leading tiles hold no visible key): the mirror
    against the plain version, and each row against the reference run
    alone at that row's prefix."""
    _, (tq, tk, tv) = _inputs(31, [(3, 70, 4, HD), (3, 256, 2, HD),
                                   (3, 256, 2, HD)], "float32", True)
    prefix = [0, 37, 150]
    kw = dict(prefix_len=torch.tensor(prefix, dtype=torch.int32), window=64)
    o = tfp.flash_prefill_split_plain(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(o), _np(tfp.flash_prefill_plain(
        tq, tk, tv, **kw)), **TOL["float32"])
    for b, p in enumerate(prefix):
        want = ref.flash_prefill_ref(*(jnp.asarray(x[b:b + 1].numpy())
                                       for x in (tq, tk, tv)),
                                     prefix_len=p, window=64)
        np.testing.assert_allclose(_np(o[b:b + 1]), _np(want),
                                   **TOL["float32"])


@pytest.mark.parametrize("pieces", [1, 3])
def test_flash_split_pieces_at_scale_hd256(pieces):
    """At q, k ~ 3 N(0, 1) and hd 256 (scores up to ~50), against the plain
    version in float64: three bf16 pieces meet fp32's 2e-5, one does
    not."""
    rs = np.random.RandomState(32)
    q, k, v = [torch.from_numpy(rs.standard_normal(s).astype(np.float32))
               * c for s, c in (((1, 128, 4, HD), 3.0),
                                ((1, 256, 2, HD), 3.0),
                                ((1, 256, 2, HD), 1.0))]
    k, v = k.bfloat16().float(), v.bfloat16().float()
    o = tfp.flash_prefill_split_plain(q, k, v, prefix_len=128,
                                      pieces=pieces)
    truth = tfp.flash_prefill_plain(q.double(), k.double(), v.double(),
                                    prefix_len=128)
    err = (o.double() - truth).abs().max().item()
    assert (err <= 2e-5) == (pieces == 3), err


# ---------------------------------------------------------------------------
# K2 decode_attention and the split-KV mirror

@functools.lru_cache(maxsize=None)
def _decode_case(dtype, window, cap):
    (q, k, v), tin = _inputs(33, [(3, 4, HD), (3, 256, 2, HD),
                                  (3, 256, 2, HD)], dtype)
    length, tlength = _ints([1, 130, 256])
    kw = dict(window=window, cap=cap)
    wants = (ref.decode_attention_ref(q, k, v, length, **kw),
             ops.decode_attention(q, k, v, length, bk=64, interpret=True,
                                  **kw))
    return tin, tlength, kw, wants


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_hd256(dtype, window, cap):
    (tq, tk, tv), tlength, kw, wants = _decode_case(dtype, window, cap)
    o = tdec.decode_attention(tq, tk, tv, tlength, **kw)
    assert o.dtype == TDT[dtype] and o.shape == (3, 4, HD)
    _check(o, wants, dtype)


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_plain_hd256(dtype, window, cap):
    """K2's split pass and merge (64-key splits, the live-split rule)."""
    (tq, tk, tv), tlength, kw, wants = _decode_case(dtype, window, cap)
    o = tdec.split_kv_plain(tq[:, None], tk, tv, tlength, **kw)[:, 0]
    _check(o, wants, dtype)


# ---------------------------------------------------------------------------
# K3 verify_attention, K4 paged_decode_attention, K5 chunk_prefill_attention
# over a pool of 16-key blocks with shuffled physical blocks

NB, BS, MAXBLK = 33, 16, 16


@functools.lru_cache(maxsize=None)
def _pool(dtype, q_shape, bf16_kv=False):
    (q, kp, vp), tin = _inputs(34, [q_shape, (NB, BS, 2, HD),
                                    (NB, BS, 2, HD)], dtype, bf16_kv)
    tables, ttables = _ints(_tables(35, q_shape[0], MAXBLK, NB))
    return (q, kp, vp, tables), tin + [ttables]


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_hd256(dtype, window, cap):
    (q, kp, vp, t), targs = _pool(dtype, (2, 4, HD))
    length, tlength = _ints([100, 256])
    kw = dict(window=window, cap=cap)
    o = tpa.paged_decode_attention(*targs, tlength, **kw)
    assert o.dtype == TDT[dtype] and o.shape == (2, 4, HD)
    _check(o, (ref.paged_decode_attention_ref(q, kp, vp, t, length, **kw),
               ops.paged_decode_attention(q, kp, vp, t, length,
                                          interpret=True, **kw)), dtype)


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_plain_hd256(dtype, window, cap):
    """A k=3 verify chunk (Sq 4), and K3's split mirror over the gathered
    view."""
    (q, kp, vp, t), (tq, tk, tv, tt) = _pool(dtype, (2, 4, 4, HD))
    length, tlength = _ints([4, 201])
    kw = dict(window=window, cap=cap)
    wants = (ref.verify_attention_ref(q, kp, vp, t, length, **kw),
             ops.verify_attention(q, kp, vp, t, length, interpret=True,
                                  **kw))
    o = tpa.verify_attention(tq, tk, tv, tt, tlength, **kw)
    assert o.dtype == TDT[dtype] and o.shape == (2, 4, 4, HD)
    _check(o, wants, dtype)
    split = tdec.split_kv_plain(tq, tpa.paged_gather(tk, tt),
                                tpa.paged_gather(tv, tt), tlength, **kw)
    _check(split, wants, dtype)


@pytest.mark.parametrize("window,cap", WINDOW_CAP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_prefill_plain_hd256(dtype, window, cap):
    """A 64-row chunk at starts 37 (mid-block) and 150, and the tile
    kernel's mirror of it over bf16-valued pools."""
    start, tstart = _ints([37, 150])
    kw = dict(window=window, cap=cap)
    for bf16_kv, fn in ((False, tcp.chunk_prefill_attention),
                        (True, tcp.chunk_prefill_split_plain)):
        (q, kp, vp, t), targs = _pool(dtype, (2, 64, 4, HD), bf16_kv)
        o = fn(*targs, tstart, **kw)
        assert o.dtype == TDT[dtype] and o.shape == (2, 64, 4, HD)
        _check(o, (ref.chunk_prefill_attention_ref(q, kp, vp, t, start,
                                                   **kw),
                   ops.chunk_prefill_attention(q, kp, vp, t, start, bq=32,
                                               interpret=True, **kw)),
               dtype)


# ---------------------------------------------------------------------------
# Gemma-2 9B reduced with its head dim kept at 256

ARCH = "gemma2-9b"


@functools.lru_cache(maxsize=None)
def _gemma():
    """Both reduced configs at hd 256, the reference's seed-0 params and
    the port's bridged copy."""
    cfg = get_config(ARCH).reduced(head_dim=HD)
    tcfg = tget_config(ARCH).reduced(head_dim=HD)
    jp = jinit(cfg, jax.random.key(0))
    tp = bridge.decoder_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def test_reduced_gemma_keeps_hd256_window_and_cap():
    cfg, tcfg, _, _ = _gemma()
    assert tcfg.resolved_head_dim == HD == cfg.resolved_head_dim
    kinds = [(sp.kind, sp.window) for st in tcfg.stages for sp in st.pattern]
    assert kinds == [("attn", 64), ("attn", None)]
    assert tcfg.attn_logit_softcap == 50.0
    assert tcfg.final_logit_softcap == 30.0


def test_reduced_gemma_hd256_logits_match():
    cfg, tcfg, jp, tp = _gemma()
    x = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16))
    jl, _, _ = japply(cfg, jp, jnp.asarray(x))
    tl, _ = tapply(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)


def test_reduced_gemma_hd256_dense_cache_chunks_match():
    """6 + 5 + 1 tokens through float32 dense caches (the windowed layer's
    ring and the global layer's linear cache): every call's logits and
    every cache leaf."""
    cfg, tcfg, jp, tp = _gemma()
    x = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16))
    jc = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jkvc.init_cache(cfg, 2, 32))
    tc = {"stages": [[{k: v.float() for k, v in el.items()} for el in st]
                     for st in tkvc.init_cache(tcfg, 2, 32,
                                               device="cpu")["stages"]]}
    for lo, hi in ((0, 6), (6, 11), (11, 12)):
        jl, jc, _ = japply(cfg, jp, jnp.asarray(x[:, lo:hi]), jc, lo)
        tl, tc = tapply(tcfg, tp, torch.from_numpy(x[:, lo:hi]), tc, lo)
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    for a, b in zip(jax.tree.leaves(jc),
                    jax.tree.leaves(tc, is_leaf=torch.is_tensor)):
        np.testing.assert_allclose(_np(b), _np(a), **LOGIT_TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_reduced_gemma_hd256_engine_greedy_tokens_match(paged):
    """The reduced engine at hd 256 on both packages, the reference
    engine's seed-0 weights bridged into the port: op_prefill of two
    prompts then op_decode of 8 tokens each, the same greedy text (paged:
    every block back after release)."""
    cfg = get_config(ARCH).reduced(head_dim=HD)
    tcfg = tget_config(ARCH).reduced(head_dim=HD)
    kw = dict(max_len=128, max_batch=4, paged=paged, block_size=8)
    ref_eng = LLMEngine("t", cfg, seed=0, **kw)
    port = TLLMEngine("t", tcfg, device="cpu", **kw)
    port.params = bridge.decoder_params(
        jax.tree.map(np.asarray, ref_eng.params), tcfg, "cpu")
    tasks = [{"sid": "a", "text": "what is fact 3 about optics"},
             {"sid": "b", "text": "an unrelated prompt of some length"}]
    out = []
    for eng in (ref_eng, port):
        eng.op_prefill([dict(t) for t in tasks])
        out.append(eng.op_decode([{"sid": "a", "max_new": 8},
                                  {"sid": "b", "max_new": 8}]))
        for sid in ("a", "b"):
            eng.release(sid)
        if paged:
            assert eng.alloc.free_blocks() == eng.alloc.capacity
    assert out[0] == out[1]
    assert all(out[1])
