"""The port's paged attention kernels (K3 verify_attention, K4
paged_decode_attention, K5 chunk_prefill_attention): their plain PyTorch
versions against the reference's pure-jnp oracles and its Pallas kernels
in interpret mode, on the same numpy-seeded inputs (shapes of
tests/test_kernels.py), at its tolerances; K5's tensor-core arithmetic
(chunk_prefill_split_plain) against the same; the paged GQA layer against
the reference's gather path; and paged_write's out-of-table drop. (The
hand-written CUDA kernels against these plain versions:
tests/test_torch_cuda.py.)"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models.transformer import apply_model  # noqa: E402
from repro.models.transformer import init_params as rinit  # noqa: E402
from repro.serving import kv_cache as rkvc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.kernels import chunk_prefill as tcp  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.transformer import apply_model as tapply  # noqa: E402
from repro_torch.serving import kv_cache as tkvc  # noqa: E402

# same tolerances as tests/test_kernels.py
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    """numpy draws -> (jax arrays, torch tensors) holding the same values
    (bf16 rounding of one float32 array is identical in both)."""
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


def _perm_tables(seed, B, maxblk, nb):
    """Distinct shuffled physical blocks per sequence (vLLM-style)."""
    perm = np.random.RandomState(seed).permutation(nb)
    return perm[: B * maxblk].reshape(B, maxblk)


def _check(o, o_ref, o_pallas, dtype):
    np.testing.assert_allclose(_np(o), _np(o_ref), **TOL[dtype])
    np.testing.assert_allclose(_np(o), _np(o_pallas), **TOL[dtype])


# ---------------------------------------------------------------------------
# K4 paged_decode_attention

@pytest.mark.parametrize("B,H,K,hd,nb,bs,maxblk", [
    (2, 4, 2, 64, 16, 16, 8), (1, 8, 8, 128, 8, 32, 4),
    (3, 4, 1, 64, 40, 8, 12),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_matches_reference(B, H, K, hd, nb, bs, maxblk,
                                              dtype):
    (q, kp, vp), (tq, tk, tv) = _inputs(
        8, [(B, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], dtype)
    tables, ttables = _ints(_perm_tables(9, B, maxblk, nb))
    length, tlength = _ints(np.arange(1, B + 1) * (maxblk * bs // (B + 1))
                            + 1)
    o = tpa.paged_decode_attention(tq, tk, tv, ttables, tlength)
    assert o.dtype == TDT[dtype] and o.shape == (B, H, hd)
    _check(o, ref.paged_decode_attention_ref(q, kp, vp, tables, length),
           ops.paged_decode_attention(q, kp, vp, tables, length,
                                      interpret=True), dtype)


def test_paged_decode_plain_window_softcap():
    B, H, K, hd, nb, bs, maxblk = 2, 4, 2, 64, 16, 16, 8
    (q, kp, vp), (tq, tk, tv) = _inputs(
        10, [(B, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], "float32")
    tables, ttables = _ints(np.arange(B * maxblk).reshape(B, maxblk) % nb)
    length, tlength = _ints([100, 128])
    kw = dict(window=64, cap=30.0)
    o = tpa.paged_decode_attention(tq, tk, tv, ttables, tlength, **kw)
    _check(o, ref.paged_decode_attention_ref(q, kp, vp, tables, length,
                                             **kw),
           ops.paged_decode_attention(q, kp, vp, tables, length,
                                      interpret=True, **kw), "float32")


# ---------------------------------------------------------------------------
# K3 verify_attention

@pytest.mark.parametrize("B,Sq,H,K,hd,nb,bs,maxblk", [
    (2, 5, 4, 2, 64, 16, 16, 8),       # GQA, draft_k=4 chunk
    (1, 3, 8, 8, 128, 8, 32, 4),       # MHA, bigger head dim
    (3, 8, 4, 1, 64, 40, 8, 12),       # MQA, chunk spans blocks
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_plain_matches_reference(B, Sq, H, K, hd, nb, bs, maxblk,
                                        dtype):
    (q, kp, vp), (tq, tk, tv) = _inputs(
        11, [(B, Sq, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], dtype)
    tables, ttables = _ints(_perm_tables(12, B, maxblk, nb))
    length, tlength = _ints(np.arange(1, B + 1) * (maxblk * bs // (B + 1))
                            + Sq)
    o = tpa.verify_attention(tq, tk, tv, ttables, tlength)
    assert o.dtype == TDT[dtype] and o.shape == (B, Sq, H, hd)
    _check(o, ref.verify_attention_ref(q, kp, vp, tables, length),
           ops.verify_attention(q, kp, vp, tables, length, interpret=True),
           dtype)


def test_verify_plain_window_softcap():
    B, Sq, H, K, hd, nb, bs, maxblk = 2, 4, 4, 2, 64, 16, 16, 8
    (q, kp, vp), (tq, tk, tv) = _inputs(
        13, [(B, Sq, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], "float32")
    tables, ttables = _ints(np.arange(B * maxblk).reshape(B, maxblk) % nb)
    length, tlength = _ints([90, 128])
    kw = dict(window=48, cap=30.0)
    o = tpa.verify_attention(tq, tk, tv, ttables, tlength, **kw)
    _check(o, ref.verify_attention_ref(q, kp, vp, tables, length, **kw),
           ops.verify_attention(q, kp, vp, tables, length, interpret=True,
                                **kw), "float32")


def test_verify_plain_qlen1_equals_paged_decode():
    B, H, K, hd, nb, bs, maxblk = 2, 4, 2, 64, 16, 16, 8
    _, (tq, tk, tv) = _inputs(
        14, [(B, 1, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], "float32")
    _, ttables = _ints(np.arange(B * maxblk).reshape(B, maxblk) % nb)
    _, tlength = _ints([70, 113])
    o = tpa.verify_attention(tq, tk, tv, ttables, tlength)
    od = tpa.paged_decode_attention(tq[:, 0], tk, tv, ttables, tlength)
    np.testing.assert_allclose(_np(o[:, 0]), _np(od), **TOL["float32"])


def test_verify_plain_causal_intra_chunk():
    """Draft position i is blind to drafts > i: perturbing the KV of the
    last chunk position changes only the last position's output."""
    B, Sq, H, K, hd, nb, bs, maxblk = 1, 4, 4, 2, 64, 8, 16, 4
    _, (tq, tk, tv) = _inputs(
        15, [(B, Sq, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], "float32")
    _, ttables = _ints(np.arange(B * maxblk).reshape(B, maxblk))
    _, tlength = _ints([40])
    o = tpa.verify_attention(tq, tk, tv, ttables, tlength)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[39 // bs, 39 % bs] += 3.0
    tv2[39 // bs, 39 % bs] += 3.0
    o2 = tpa.verify_attention(tq, tk2, tv2, ttables, tlength)
    np.testing.assert_allclose(_np(o[:, :-1]), _np(o2[:, :-1]),
                               **TOL["float32"])
    assert not np.allclose(_np(o[:, -1]), _np(o2[:, -1]))


# ---------------------------------------------------------------------------
# K5 chunk_prefill_attention

@pytest.mark.parametrize("B,Sq,H,K,hd,nb,bs,maxblk,starts", [
    (2, 64, 4, 2, 64, 24, 16, 8, (37, 0)),     # GQA, mid-block + zero start
    (1, 32, 8, 1, 128, 12, 32, 4, (64,)),      # MQA, start at block boundary
    (3, 16, 4, 4, 64, 40, 8, 12, (5, 48, 79)),  # MHA, tiny blocks
    (2, 128, 4, 2, 64, 24, 16, 12, (16, 33)),  # chunk > block, q tiled
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_prefill_plain_matches_reference(B, Sq, H, K, hd, nb, bs,
                                               maxblk, starts, dtype):
    (q, kp, vp), (tq, tk, tv) = _inputs(
        21, [(B, Sq, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], dtype)
    tables, ttables = _ints(
        (np.arange(B * maxblk).reshape(B, maxblk) % (nb - 1)) + 1)
    start, tstart = _ints(starts)
    o = tcp.chunk_prefill_attention(tq, tk, tv, ttables, tstart)
    assert o.dtype == TDT[dtype] and o.shape == (B, Sq, H, hd)
    _check(o, ref.chunk_prefill_attention_ref(q, kp, vp, tables, start),
           ops.chunk_prefill_attention(q, kp, vp, tables, start, bq=32,
                                       interpret=True), dtype)


@pytest.mark.parametrize("window,cap", [(24, None), (None, 30.0),
                                        (40, 50.0)])
def test_chunk_prefill_plain_window_softcap(window, cap):
    B, Sq, H, K, hd, nb, bs, maxblk = 2, 64, 4, 2, 64, 24, 16, 8
    (q, kp, vp), (tq, tk, tv) = _inputs(
        22, [(B, Sq, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], "float32")
    tables, ttables = _ints(
        (np.arange(B * maxblk).reshape(B, maxblk) % (nb - 1)) + 1)
    start, tstart = _ints([41, 8])
    kw = dict(window=window, cap=cap)
    o = tcp.chunk_prefill_attention(tq, tk, tv, ttables, tstart, **kw)
    _check(o, ref.chunk_prefill_attention_ref(q, kp, vp, tables, start,
                                              **kw),
           ops.chunk_prefill_attention(q, kp, vp, tables, start, bq=32,
                                       interpret=True, **kw), "float32")


def test_chunk_prefill_plain_qlen1_equals_paged_decode():
    B, H, K, hd, nb, bs, maxblk = 2, 4, 2, 64, 16, 16, 8
    _, (tq, tk, tv) = _inputs(
        23, [(B, 1, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], "float32")
    _, ttables = _ints(np.arange(B * maxblk).reshape(B, maxblk) % nb)
    _, tlength = _ints([70, 113])
    o = tcp.chunk_prefill_attention(tq, tk, tv, ttables, tlength - 1)
    od = tpa.paged_decode_attention(tq[:, 0], tk, tv, ttables, tlength)
    np.testing.assert_allclose(_np(o[:, 0]), _np(od), **TOL["float32"])


def test_chunk_prefill_plain_two_chunks_equal_one_shot():
    """[0,64) then [64,128) over the paged pool reproduces one [0,128)
    call's outputs for the second chunk."""
    B, S, H, K, hd, nb, bs = 1, 128, 4, 2, 64, 10, 16
    maxblk = S // bs
    _, (tq, tk, tv) = _inputs(
        24, [(B, S, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], "float32")
    _, ttables = _ints(np.arange(1, maxblk + 1)[None, :])
    one = tcp.chunk_prefill_attention(tq, tk, tv, ttables, 0)
    part2 = tcp.chunk_prefill_attention(tq[:, 64:], tk, tv, ttables, 64)
    np.testing.assert_allclose(_np(one[:, 64:]), _np(part2),
                               **TOL["float32"])


# ---------------------------------------------------------------------------
# K5's tensor-core arithmetic: chunk_prefill_split_plain (q and P in three
# bf16 pieces, 64-key tiles over the gathered view)

def _bf16_pools(seed, shapes, dtype):
    """As _inputs, with the pools rounded to bf16 values (the engines'
    cache dtype: exact tensor-core operands)."""
    rs = np.random.RandomState(seed)
    xs = [rs.standard_normal(s).astype(np.float32) for s in shapes]
    xs[1:] = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
              for x in xs[1:]]
    return ([jnp.asarray(x, JDT[dtype]) for x in xs],
            [torch.from_numpy(x).to(TDT[dtype]) for x in xs])


@pytest.mark.parametrize("B,Sq,H,K,hd,nb,bs,maxblk,starts", [
    (2, 64, 4, 2, 64, 24, 16, 8, (37, 0)),     # GQA, mid-block + zero start
    (1, 32, 8, 1, 128, 12, 32, 4, (64,)),      # MQA, start at block boundary
    (3, 16, 4, 4, 64, 40, 8, 12, (5, 48, 79)),  # MHA, tiny blocks
    (2, 128, 4, 2, 64, 24, 16, 12, (16, 33)),  # chunk > block, q tiled
    (2, 17, 8, 2, 64, 24, 16, 8, (63, 15)),    # ragged chunk beside edges
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_split_plain_matches_reference(B, Sq, H, K, hd, nb, bs,
                                             maxblk, starts, dtype):
    (q, kp, vp), (tq, tk, tv) = _bf16_pools(
        25, [(B, Sq, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], dtype)
    tables, ttables = _ints(
        (np.arange(B * maxblk).reshape(B, maxblk) % (nb - 1)) + 1)
    start, tstart = _ints(starts)
    o = tcp.chunk_prefill_split_plain(tq, tk, tv, ttables, tstart)
    assert o.dtype == TDT[dtype] and o.shape == (B, Sq, H, hd)
    _check(o, ref.chunk_prefill_attention_ref(q, kp, vp, tables, start),
           ops.chunk_prefill_attention(q, kp, vp, tables, start, bq=32,
                                       interpret=True), dtype)


@pytest.mark.parametrize("window,cap", [(24, None), (None, 30.0),
                                        (40, 50.0)])
def test_chunk_split_plain_window_softcap(window, cap):
    B, Sq, H, K, hd, nb, bs, maxblk = 2, 64, 4, 2, 64, 24, 16, 8
    (q, kp, vp), (tq, tk, tv) = _bf16_pools(
        26, [(B, Sq, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], "float32")
    tables, ttables = _ints(_perm_tables(27, B, maxblk, nb))
    start, tstart = _ints([41, 8])
    kw = dict(window=window, cap=cap)
    o = tcp.chunk_prefill_split_plain(tq, tk, tv, ttables, tstart, **kw)
    _check(o, ref.chunk_prefill_attention_ref(q, kp, vp, tables, start,
                                              **kw),
           ops.chunk_prefill_attention(q, kp, vp, tables, start, bq=32,
                                       interpret=True, **kw), "float32")


def test_verify_plain_computes_in_float64_for_float64_inputs():
    """K3's and K5's plain version is the float64 referee of the CUDA tests
    at large scores: float64 inputs are computed in float64 (not rounded
    through float32), float32 inputs as before."""
    B, Sq, H, K, hd, nb, bs, maxblk = 2, 8, 4, 2, 64, 16, 16, 8
    _, (tq, tk, tv) = _bf16_pools(
        28, [(B, Sq, H, hd), (nb, bs, K, hd), (nb, bs, K, hd)], "float32")
    tq = tq * 3.0
    _, ttables = _ints(_perm_tables(29, B, maxblk, nb))
    _, tlength = _ints([40, 128])
    o32 = tpa.verify_attention_plain(tq, tk, tv, ttables, tlength)
    o64 = tpa.verify_attention_plain(tq.double(), tk.double(), tv.double(),
                                     ttables, tlength)
    assert o32.dtype == torch.float32 and o64.dtype == torch.float64
    np.testing.assert_allclose(o64.numpy(), o32.double().numpy(),
                               **TOL["float32"])
    assert not torch.equal(o64, o32.double())
    c64 = tcp.chunk_prefill_attention_plain(tq.double(), tk.double(),
                                            tv.double(), ttables,
                                            tlength - Sq)
    assert torch.equal(c64, o64)


# ---------------------------------------------------------------------------
# the paged GQA layer and paged_write

def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def test_paged_model_matches_reference_gather_path():
    """apply_model over a paged pool (tiny-lite-llm has a sliding-window
    layer, paged linearly): two prefill chunks (K5), a verify chunk (K3)
    and a decode step (K4) in the port, against the reference's default
    gather path on the same weights and tables."""
    import jax
    name = "tiny-lite-llm"
    cfg, tcfg = get_config(name), tget_config(name)
    params = rinit(cfg, jax.random.key(0))
    tparams = bridge.decoder_params(_np_tree(params), tcfg, "cpu")
    rs = np.random.RandomState(1)
    chunks = [rs.randint(0, cfg.vocab_size, (2, n)) for n in (6, 4, 3, 1)]
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    pos0 = np.array([5, 2], np.int32)
    pool = rkvc.init_paged_pool(cfg, 8, 8)
    tpool = tkvc.init_paged_pool(tcfg, 8, 8, device="cpu")
    p = pos0
    for i, toks in enumerate(chunks):
        want, pool, _ = apply_model(cfg, params, jnp.asarray(toks), pool,
                                    jnp.asarray(p),
                                    block_tables=jnp.asarray(tables))
        with torch.inference_mode():
            got, _ = tapply(tcfg, tparams, torch.from_numpy(toks), tpool,
                            torch.from_numpy(p),
                            block_tables=torch.from_numpy(tables),
                            verify=(i == 2))
        # bf16 pool: held at 5e-3 as in tests/test_torch_model.py (a
        # last-bit fp32 difference in a projection can round the stored
        # K/V to a neighbouring bf16 value)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-3, atol=5e-3)
        p = p + toks.shape[1]
    # the same pool contents outside the scratch pad block (bf16 K/V: a
    # projection differing in its last fp32 bit may round one bf16 ulp
    # apart)
    for relems, telems in zip(pool["stages"], tpool["stages"]):
        for re_, te in zip(relems, telems):
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    te[key][:, 1:].float().numpy(),
                    np.asarray(re_[key][:, 1:], np.float32),
                    rtol=1e-2, atol=1e-2)


def test_paged_write_drops_out_of_table_positions():
    """A position past the table's width is dropped (the reference's
    fill-mode lookup discards the scatter): no live block changes; the
    write lands on the scratch pad block only."""
    bs, maxblk = 4, 2
    rs = np.random.RandomState(3)
    pool0 = rs.standard_normal((6, bs, 1, 2)).astype(np.float32)
    chunk = rs.standard_normal((2, 1, 1, 2)).astype(np.float32)
    tables = np.array([[3, 1], [2, 5]], np.int32)
    positions = np.array([[8], [6]], np.int32)     # row 0: past the table
    want = rattn.paged_write(jnp.asarray(pool0), jnp.asarray(chunk),
                             jnp.asarray(tables), jnp.asarray(positions))
    got = tattn.paged_write(torch.from_numpy(pool0.copy()),
                            torch.from_numpy(chunk), torch.from_numpy(tables),
                            torch.from_numpy(positions))
    np.testing.assert_array_equal(got[1:].numpy(), np.asarray(want)[1:])
    np.testing.assert_array_equal(got[5, 2], chunk[1, 0])
    assert not np.array_equal(got[1:].numpy(), pool0[1:])
