"""The split-KV (flash-decoding) algorithm of the port's K2
decode_attention, K3 verify_attention and K4 paged_decode_attention
kernels (csrc/split_kv.cuh),
mirrored in plain PyTorch (``split_kv_plain``: the same chunk of keys,
the same rule for which chunks are live, the same (m, l, acc) merge),
against the reference's pure-jnp oracles and its Pallas kernels in
interpret mode, on the same numpy-seeded inputs (shapes of
tests/test_kernels.py), at its tolerances. The CUDA kernels themselves
are held against the plain versions on the card (tests/test_torch_cuda.py).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

# same tolerances as tests/test_kernels.py
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    """numpy draws -> (jax arrays, torch tensors) holding the same
    values."""
    rs = np.random.RandomState(seed)
    xs = [rs.standard_normal(s).astype(np.float32) for s in shapes]
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


# ---------------------------------------------------------------------------
# which splits are live

@pytest.mark.parametrize("Sq", [1, 4])
@pytest.mark.parametrize("window", [0, 1, 30])
def test_live_splits_are_the_chunks_with_a_visible_key(Sq, window):
    """A split is live exactly when some query row sees one of its keys,
    at every length from 0 past the span."""
    chunk, span = 16, 100
    for length in range(0, span + 10):
        visible = set()
        for s in range(Sq):
            qpos = length - Sq + s
            visible |= {j for j in range(span)
                        if j <= qpos and (not window or j > qpos - window)}
        live = tdec.live_splits(length, Sq, span, window, chunk)
        assert set(live) == {j // chunk for j in visible}, length


# ---------------------------------------------------------------------------
# K2 decode_attention

@functools.lru_cache(maxsize=None)
def _decode_case(B, H, K, hd, T, dtype, lengths, window, cap):
    (q, k, v), tin = _inputs(2, [(B, H, hd), (B, T, K, hd), (B, T, K, hd)],
                             dtype)
    length, tlength = _ints(lengths)
    kw = dict(window=window, cap=cap)
    wants = (ref.decode_attention_ref(q, k, v, length, **kw),
             ops.decode_attention(q, k, v, length, bk=64, interpret=True,
                                  **kw))
    return tin, tlength, wants


@pytest.mark.parametrize("B,H,K,hd,T", [
    (2, 4, 2, 64, 256), (1, 8, 8, 128, 128), (3, 4, 1, 64, 512),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 64, "T"])
def test_decode_split_matches_reference(B, H, K, hd, T, dtype, chunk):
    lengths = tuple(int(n) for n in np.arange(1, B + 1) * (T // (B + 1)) + 1)
    (tq, tk, tv), tlength, wants = _decode_case(B, H, K, hd, T, dtype,
                                                lengths, None, None)
    o = tdec.split_kv_plain(tq[:, None], tk, tv, tlength,
                            chunk=T if chunk == "T" else chunk)[:, 0]
    assert o.dtype == TDT[dtype] and o.shape == (B, H, hd)
    _check(o, wants, dtype)


@pytest.mark.parametrize("chunk", [16, 64, 256])
@pytest.mark.parametrize("window,cap", [(None, None), (40, None),
                                        (None, 30.0), (100, 50.0)])
def test_decode_split_lengths_at_chunk_edges(chunk, window, cap):
    """Length 1, lengths on and beside the 16- and 64-key edges, the full
    cache; window 40 leaves the leading chunks of the long rows with no
    visible key (they are skipped, not merged)."""
    lengths = (1, 15, 16, 17, 63, 64, 65, 255, 256)
    (tq, tk, tv), tlength, wants = _decode_case(len(lengths), 8, 2, 64, 256,
                                                "float32", lengths, window,
                                                cap)
    o = tdec.split_kv_plain(tq[:, None], tk, tv, tlength, window=window,
                            cap=cap, chunk=chunk)[:, 0]
    _check(o, wants, "float32")


# ---------------------------------------------------------------------------
# K3 verify_attention

def _verify_split(q, k_pool, v_pool, tables, length, **kw):
    """K3's split algorithm over the gathered view of the pool."""
    return tdec.split_kv_plain(q, tpa.paged_gather(k_pool, tables),
                               tpa.paged_gather(v_pool, tables), length, **kw)


def _perm_tables(seed, B, maxblk, nb):
    perm = np.random.RandomState(seed).permutation(nb)
    return perm[: B * maxblk].reshape(B, maxblk)


@functools.lru_cache(maxsize=None)
def _verify_case(B, Sq, H, K, hd, nb, bs, maxblk, dtype, lengths, window,
                 cap, tables=None):
    (q, kp, vp), tin = _inputs(11, [(B, Sq, H, hd), (nb, bs, K, hd),
                                    (nb, bs, K, hd)], dtype)
    if tables is None:
        tables = _perm_tables(12, B, maxblk, nb)
    tables, ttables = _ints(tables)
    length, tlength = _ints(lengths)
    kw = dict(window=window, cap=cap)
    wants = (ref.verify_attention_ref(q, kp, vp, tables, length, **kw),
             ops.verify_attention(q, kp, vp, tables, length, interpret=True,
                                  **kw))
    return tin, ttables, tlength, wants


@pytest.mark.parametrize("B,Sq,H,K,hd,nb,bs,maxblk", [
    (2, 5, 4, 2, 64, 16, 16, 8),       # GQA, draft_k=4 chunk
    (1, 3, 8, 8, 128, 8, 32, 4),       # MHA, bigger head dim
    (3, 8, 4, 1, 64, 40, 8, 12),       # MQA, chunk spans blocks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 64, "T"])
def test_verify_split_matches_reference(B, Sq, H, K, hd, nb, bs, maxblk,
                                        dtype, chunk):
    lengths = tuple(int(n) for n in
                    np.arange(1, B + 1) * (maxblk * bs // (B + 1)) + Sq)
    (tq, tk, tv), ttables, tlength, wants = _verify_case(
        B, Sq, H, K, hd, nb, bs, maxblk, dtype, lengths, None, None)
    o = _verify_split(tq, tk, tv, ttables, tlength,
                      chunk=maxblk * bs if chunk == "T" else chunk)
    assert o.dtype == TDT[dtype] and o.shape == (B, Sq, H, hd)
    _check(o, wants, dtype)


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("window,cap", [(None, None), (48, 30.0)])
def test_verify_split_chunk_straddles_split_edges(chunk, window, cap):
    """Verify chunks of 5 positions that start in one split and end in the
    next (positions 13-17 and 61-65), one at the start of the cache and
    one at its end; the causal edge then falls inside a split."""
    lengths = (5, 18, 66, 128)
    (tq, tk, tv), ttables, tlength, wants = _verify_case(
        4, 5, 4, 2, 64, 40, 16, 8, "float32", lengths, window, cap)
    o = _verify_split(tq, tk, tv, ttables, tlength, window=window, cap=cap,
                      chunk=chunk)
    _check(o, wants, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_split_shared_prefix_table(dtype):
    """Three rows forked from one prefix (a copy-on-write table: their
    first three physical blocks are the same), diverging after it."""
    t = _perm_tables(13, 3, 8, 40)
    t[1:, :3] = t[0, :3]
    (tq, tk, tv), ttables, tlength, wants = _verify_case(
        3, 4, 4, 2, 64, 40, 16, 8, dtype, (52, 52, 90), None, None,
        tables=tuple(map(tuple, t)))
    o = _verify_split(tq, tk, tv, ttables, tlength, chunk=16)
    _check(o, wants, dtype)


# ---------------------------------------------------------------------------
# K4 paged_decode_attention: the paged Sq = 1 instance

@functools.lru_cache(maxsize=None)
def _paged_decode_case(B, H, K, hd, nb, bs, maxblk, dtype, lengths, window,
                       cap):
    (q, kp, vp), tin = _inputs(14, [(B, H, hd), (nb, bs, K, hd),
                                    (nb, bs, K, hd)], dtype)
    tables, ttables = _ints(_perm_tables(15, B, maxblk, nb))
    length, tlength = _ints(lengths)
    kw = dict(window=window, cap=cap)
    wants = (ref.paged_decode_attention_ref(q, kp, vp, tables, length, **kw),
             ops.paged_decode_attention(q, kp, vp, tables, length,
                                        interpret=True, **kw))
    return tin, ttables, tlength, wants


@pytest.mark.parametrize("B,H,K,hd,nb,bs,maxblk", [
    (2, 4, 2, 64, 16, 16, 8),          # GQA
    (1, 8, 8, 128, 8, 32, 4),          # MHA, bigger head dim
    (3, 4, 1, 64, 40, 8, 12),          # MQA, small blocks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 64, "T"])
def test_paged_decode_split_matches_reference(B, H, K, hd, nb, bs, maxblk,
                                              dtype, chunk):
    """K4's split algorithm (one query row per head: length - 1 is the new
    token's position) over the gathered view, on shuffled physical blocks,
    at tests/test_kernels.py's paged-decode shapes."""
    lengths = tuple(int(n) for n in
                    np.arange(1, B + 1) * (maxblk * bs // (B + 1)) + 1)
    (tq, tk, tv), ttables, tlength, wants = _paged_decode_case(
        B, H, K, hd, nb, bs, maxblk, dtype, lengths, None, None)
    o = _verify_split(tq[:, None], tk, tv, ttables, tlength,
                      chunk=maxblk * bs if chunk == "T" else chunk)[:, 0]
    assert o.dtype == TDT[dtype] and o.shape == (B, H, hd)
    _check(o, wants, dtype)


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("window,cap", [(None, None), (40, None),
                                        (None, 30.0), (100, 50.0)])
def test_paged_decode_split_lengths_at_chunk_edges(chunk, window, cap):
    """Length 1, lengths on and beside the 16- and 64-key edges and the
    full 192-key span, over 16-key blocks in shuffled order; window 40
    leaves the leading chunks of the long rows with no visible key."""
    lengths = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 192)
    B, maxblk = len(lengths), 12
    (tq, tk, tv), ttables, tlength, wants = _paged_decode_case(
        B, 8, 2, 64, B * maxblk + 1, 16, maxblk, "float32", lengths, window,
        cap)
    o = _verify_split(tq[:, None], tk, tv, ttables, tlength, window=window,
                      cap=cap, chunk=chunk)[:, 0]
    _check(o, wants, "float32")
