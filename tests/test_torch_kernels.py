"""The port's attention kernels (K1 flash_prefill, K2 decode_attention):
their plain PyTorch versions against the reference's pure-jnp oracles and
its Pallas kernels in interpret mode, on the same numpy-seeded inputs, at
the tolerances of tests/test_kernels.py; and K1's tensor-core arithmetic
(``flash_prefill_split_plain``: bf16 pieces of q and P) against the same
oracles and against float64. (The hand-written CUDA kernels against these
plain versions: tests/test_torch_cuda.py.)"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_prefill as tfp  # noqa: E402

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


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("B,Sq,H,K,hd,T,prefix", [
    (1, 128, 4, 4, 64, 128, 0),        # plain causal (MHA)
    (2, 128, 4, 2, 64, 256, 64),       # GQA + prefix (partial prefill)
    (1, 256, 8, 1, 128, 512, 128),     # MQA, bigger head dim
    (2, 64, 4, 2, 64, 256, 192),       # chunk smaller than block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_plain_matches_reference(B, Sq, H, K, hd, T, prefix,
                                               dtype):
    (q, k, v), (tq, tk, tv) = _inputs(
        0, [(B, Sq, H, hd), (B, T, K, hd), (B, T, K, hd)], dtype)
    o_ref = ref.flash_prefill_ref(q, k, v, prefix_len=prefix)
    o_pallas = ops.flash_prefill(q, k, v, prefix_len=prefix, bq=64, bk=64,
                                 interpret=True)
    o = tfp.flash_prefill(tq, tk, tv, prefix_len=prefix)
    assert o.dtype == TDT[dtype] and o.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(_np(o), _np(o_ref), **TOL[dtype])
    np.testing.assert_allclose(_np(o), _np(o_pallas), **TOL[dtype])


@pytest.mark.parametrize("window,cap", [(64, None), (None, 30.0),
                                        (100, 50.0)])
def test_flash_prefill_plain_window_softcap(window, cap):
    B, Sq, H, K, hd, T, prefix = 2, 128, 4, 2, 64, 256, 96
    (q, k, v), (tq, tk, tv) = _inputs(
        1, [(B, Sq, H, hd), (B, T, K, hd), (B, T, K, hd)], "float32")
    o_ref = ref.flash_prefill_ref(q, k, v, prefix_len=prefix, window=window,
                                  cap=cap)
    o_pallas = ops.flash_prefill(q, k, v, prefix_len=prefix, window=window,
                                 cap=cap, bq=64, bk=64, interpret=True)
    o = tfp.flash_prefill(tq, tk, tv, prefix_len=prefix, window=window,
                          cap=cap)
    np.testing.assert_allclose(_np(o), _np(o_ref), **TOL["float32"])
    np.testing.assert_allclose(_np(o), _np(o_pallas), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_plain_per_sequence_prefix(dtype):
    """The port takes prefix_len per sequence (the engine batches
    sequences at different positions): each row must equal the
    reference run alone at that row's static prefix."""
    B, Sq, H, K, hd, T = 3, 64, 4, 2, 64, 256
    prefixes = [0, 37, 192]
    (q, k, v), (tq, tk, tv) = _inputs(
        2, [(B, Sq, H, hd), (B, T, K, hd), (B, T, K, hd)], dtype)
    o = tfp.flash_prefill(tq, tk, tv,
                          prefix_len=torch.tensor(prefixes, dtype=torch.int32))
    for b, pre in enumerate(prefixes):
        o_ref = ref.flash_prefill_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                      prefix_len=pre)
        np.testing.assert_allclose(_np(o[b:b + 1]), _np(o_ref), **TOL[dtype])


def test_flash_prefill_plain_total_len_clamps_keys():
    """total_len below prefix+Sq masks the keys past it, as the
    reference's static total_len does."""
    B, Sq, H, K, hd, T, prefix, total = 1, 64, 4, 2, 64, 256, 64, 100
    (q, k, v), (tq, tk, tv) = _inputs(
        3, [(B, Sq, H, hd), (B, T, K, hd), (B, T, K, hd)], "float32")
    o_ref = ref.flash_prefill_ref(q, k, v, prefix_len=prefix,
                                  total_len=total)
    o = tfp.flash_prefill(tq, tk, tv, prefix_len=prefix, total_len=total)
    np.testing.assert_allclose(_np(o), _np(o_ref), **TOL["float32"])


@pytest.mark.parametrize("B,H,K,hd,T", [
    (2, 4, 2, 64, 256), (1, 8, 8, 128, 128), (3, 4, 1, 64, 512),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_reference(B, H, K, hd, T, dtype):
    (q, k, v), (tq, tk, tv) = _inputs(
        4, [(B, H, hd), (B, T, K, hd), (B, T, K, hd)], dtype)
    length = np.arange(1, B + 1) * (T // (B + 1)) + 1
    o_ref = ref.decode_attention_ref(q, k, v, jnp.asarray(length))
    o_pallas = ops.decode_attention(q, k, v, jnp.asarray(length), bk=64,
                                    interpret=True)
    o = tdec.decode_attention(tq, tk, tv, torch.from_numpy(length))
    assert o.dtype == TDT[dtype] and o.shape == (B, H, hd)
    np.testing.assert_allclose(_np(o), _np(o_ref), **TOL[dtype])
    np.testing.assert_allclose(_np(o), _np(o_pallas), **TOL[dtype])


@pytest.mark.parametrize("window,cap", [(64, None), (64, 30.0)])
def test_decode_attention_plain_window_softcap(window, cap):
    B, H, K, hd, T = 2, 4, 2, 64, 256
    (q, k, v), (tq, tk, tv) = _inputs(
        5, [(B, H, hd), (B, T, K, hd), (B, T, K, hd)], "float32")
    length = np.array([200, 256])
    o_ref = ref.decode_attention_ref(q, k, v, jnp.asarray(length),
                                     window=window, cap=cap)
    o_pallas = ops.decode_attention(q, k, v, jnp.asarray(length),
                                    window=window, cap=cap, bk=64,
                                    interpret=True)
    o = tdec.decode_attention(tq, tk, tv, torch.from_numpy(length),
                              window=window, cap=cap)
    np.testing.assert_allclose(_np(o), _np(o_ref), **TOL["float32"])
    np.testing.assert_allclose(_np(o), _np(o_pallas), **TOL["float32"])


def test_decode_equals_one_row_prefill():
    """K2 at length L is K1 for a one-query chunk at prefix L-1."""
    B, H, K, hd, T = 2, 8, 2, 64, 128
    _, (tq, tk, tv) = _inputs(6, [(B, H, hd), (B, T, K, hd), (B, T, K, hd)],
                              "float32")
    length = torch.tensor([17, 128], dtype=torch.int32)
    od = tdec.decode_attention(tq, tk, tv, length)
    op = tfp.flash_prefill(tq[:, None], tk, tv, prefix_len=length - 1)
    np.testing.assert_allclose(_np(od), _np(op[:, 0]), rtol=2e-5, atol=2e-5)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions: the kernel
    launch counters do not move."""
    before = (tfp.flash_prefill.launches, tdec.decode_attention.launches)
    _, (tq, tk, tv) = _inputs(7, [(1, 8, 2, 64), (1, 16, 1, 64),
                                  (1, 16, 1, 64)], "float32")
    tfp.flash_prefill(tq, tk, tv, prefix_len=4)
    tdec.decode_attention(tq[:, 0], tk, tv, torch.tensor([5]))
    assert (tfp.flash_prefill.launches,
            tdec.decode_attention.launches) == before


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 8, 2, 64), device="meta")
    k = torch.zeros((1, 16, 1, 64), device="meta")
    with pytest.raises(ValueError):
        tfp.flash_prefill(q, k, k)
    with pytest.raises(ValueError):
        tdec.decode_attention(q[:, 0], k, k, torch.tensor([5]))


# ---------------------------------------------------------------------------
# K1's tensor-core arithmetic: q and P in three bf16 pieces

def _split_inputs(seed, B, Sq, H, K, hd, T, dtype, qk_scale=1.0):
    """q, k ~ qk_scale * N(0, 1), v ~ N(0, 1), K/V rounded to bf16 values
    (the engines' cache dtype: exact tensor-core operands), as (jax
    arrays, torch tensors) holding the same values."""
    rs = np.random.RandomState(seed)
    q, k, v = [rs.standard_normal(s).astype(np.float32) * c for s, c in (
        ((B, Sq, H, hd), qk_scale), ((B, T, K, hd), qk_scale),
        ((B, T, K, hd), 1.0))]
    k, v = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
            for x in (k, v)]
    xs = (q, k, v)
    return ([jnp.asarray(x, JDT[dtype]) for x in xs],
            [torch.from_numpy(x).to(TDT[dtype]) for x in xs])


@pytest.mark.parametrize("B,Sq,H,K,hd,T,prefix", [
    (1, 128, 4, 4, 64, 128, 0),        # plain causal (MHA)
    (2, 128, 4, 2, 64, 256, 64),       # GQA + prefix (partial prefill)
    (1, 256, 8, 1, 128, 512, 128),     # MQA, bigger head dim
    (2, 64, 4, 2, 64, 256, 192),       # chunk smaller than block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_split_plain_matches_reference(B, Sq, H, K, hd, T, prefix,
                                             dtype):
    (q, k, v), (tq, tk, tv) = _split_inputs(10, B, Sq, H, K, hd, T, dtype)
    o_ref = ref.flash_prefill_ref(q, k, v, prefix_len=prefix)
    o_pallas = ops.flash_prefill(q, k, v, prefix_len=prefix, bq=64, bk=64,
                                 interpret=True)
    o = tfp.flash_prefill_split_plain(tq, tk, tv, prefix_len=prefix)
    assert o.dtype == TDT[dtype] and o.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(_np(o), _np(o_ref), **TOL[dtype])
    np.testing.assert_allclose(_np(o), _np(o_pallas), **TOL[dtype])


@pytest.mark.parametrize("window,cap", [(64, None), (None, 30.0),
                                        (100, 50.0)])
def test_flash_split_plain_window_softcap(window, cap):
    B, Sq, H, K, hd, T, prefix = 2, 128, 4, 2, 64, 256, 96
    (q, k, v), (tq, tk, tv) = _split_inputs(11, B, Sq, H, K, hd, T,
                                            "float32")
    kw = dict(prefix_len=prefix, window=window, cap=cap)
    o_ref = ref.flash_prefill_ref(q, k, v, **kw)
    o_pallas = ops.flash_prefill(q, k, v, bq=64, bk=64, interpret=True, **kw)
    o = tfp.flash_prefill_split_plain(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(o), _np(o_ref), **TOL["float32"])
    np.testing.assert_allclose(_np(o), _np(o_pallas), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_split_plain_ragged_per_sequence_prefix(dtype, window):
    """A ragged chunk (Sq = 100, not a multiple of the 64-key tile) at
    per-sequence prefixes 0 / 37 / 150; with window 64 the long rows'
    leading tiles hold no visible key. Against the plain version."""
    _, (tq, tk, tv) = _split_inputs(12, 3, 100, 8, 2, 64, 256, dtype)
    kw = dict(prefix_len=torch.tensor([0, 37, 150], dtype=torch.int32),
              window=window)
    o = tfp.flash_prefill_split_plain(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(o), _np(tfp.flash_prefill_plain(
        tq, tk, tv, **kw)), **TOL[dtype])


@pytest.mark.parametrize("pieces", [1, 2, 3])
def test_flash_split_pieces_needed_at_scale(pieces):
    """Why q and P go in three bf16 pieces: at q, k ~ 3 N(0, 1) (hd 128,
    scores up to ~40) against float64, three pieces meet fp32's 2e-5 and
    one or two do not (one misses by three orders of magnitude)."""
    _, (tq, tk, tv) = _split_inputs(13, 1, 256, 8, 1, 128, 512, "float32",
                                    qk_scale=3.0)
    o = tfp.flash_prefill_split_plain(tq, tk, tv, prefix_len=128,
                                      pieces=pieces)
    truth = tfp.flash_prefill_plain(tq.double(), tk.double(), tv.double(),
                                    prefix_len=128)
    err = (o.double() - truth).abs().max().item()
    assert (err <= 2e-5) == (pieces == 3), err
