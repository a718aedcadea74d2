"""On a CUDA card: the port's hand-written kernels against their plain
PyTorch versions, and the dense and paged model paths through them
against the same code on the CPU. Imports no JAX, so it runs where only
the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a card every test skips."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.bridge import tree_to  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import chunk_prefill as tcp  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_prefill as tfp  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models.transformer import apply_model, init_params  # noqa: E402
from repro_torch.serving import kv_cache as kvc  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(rs, shape, dev, dtype):
    return torch.from_numpy(rs.standard_normal(shape).astype(
        np.float32)).to(dev, dtype)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("window,cap", [(None, None), (100, 50.0)])
def test_kernels_match_plain(cuda, qdt, hd, window, cap):
    B, Sq, H, K, T = 3, 96, 8, 2, 256
    rs = np.random.RandomState(8)
    q = _randn(rs, (B, Sq, H, hd), cuda, qdt)
    k = _randn(rs, (B, T, K, hd), cuda, torch.bfloat16)
    v = _randn(rs, (B, T, K, hd), cuda, torch.bfloat16)
    tol = 2e-5 if qdt == torch.float32 else 2e-2
    prefix = torch.tensor([0, 41, 160], dtype=torch.int32, device=cuda)
    n0 = tfp.flash_prefill.launches
    o = tfp.flash_prefill(q, k, v, prefix_len=prefix, window=window, cap=cap)
    torch.cuda.synchronize()
    assert tfp.flash_prefill.launches == n0 + 1
    o_plain = tfp.flash_prefill_plain(q, k, v, prefix_len=prefix,
                                      window=window, cap=cap)
    torch.testing.assert_close(o.float(), o_plain.float(), rtol=tol,
                               atol=tol)
    length = torch.tensor([1, 100, 256], dtype=torch.int32, device=cuda)
    n0 = tdec.decode_attention.launches
    od = tdec.decode_attention(q[:, 0], k, v, length, window=window, cap=cap)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == n0 + 1
    od_plain = tdec.decode_attention_plain(q[:, 0], k, v, length,
                                           window=window, cap=cap)
    torch.testing.assert_close(od.float(), od_plain.float(), rtol=tol,
                               atol=tol)


def test_model_on_card_matches_cpu(cuda):
    """tiny-core-llm prefill, partial prefill and decode on the card
    (through the kernels) against the CPU (plain attention), same weights.
    Tolerance 5e-3, as for the port against the reference with bf16 K/V
    (tests/test_torch_model.py): a projection that differs in its last
    fp32 bit between the two devices can round to a neighbouring bf16
    value, which moves the logits by up to ~2e-3."""
    cfg = get_config("tiny-core-llm")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    params_dev = tree_to(params, cuda)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 60))
    pos = [0, 7]
    outs = {}
    for dev, p in (("cpu", params), (cuda, params_dev)):
        cache = kvc.init_cache(cfg, 2, 128, device=dev)
        got = []
        with torch.inference_mode():
            for lo, hi in ((0, 40), (40, 56), (56, 57), (57, 58)):
                x = torch.as_tensor(toks[:, lo:hi], device=dev)
                P = torch.tensor(pos, device=dev) + lo
                logits, cache = apply_model(cfg, p, x, cache, P)
                got.append(logits.float().cpu())
        outs[str(dev)] = got
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        torch.testing.assert_close(b, a, rtol=5e-3, atol=5e-3)


def _launch_and_compare(fn, plain, args, kw, tol):
    n0 = fn.launches
    o = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    torch.testing.assert_close(o.float(), plain(*args, **kw).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("window,cap", [(None, None), (100, 50.0)])
def test_paged_kernels_match_plain(cuda, qdt, hd, window, cap):
    """K4 paged decode, K3 verify (Sq=4) and K5 chunked prefill (ragged
    Sq=70) over a bf16 pool with shuffled physical blocks, two rows
    sharing their first two blocks as a COW fork does."""
    B, H, K, nb, bs, maxblk = 3, 8, 2, 40, 16, 12
    rs = np.random.RandomState(9)
    kp = _randn(rs, (nb, bs, K, hd), cuda, torch.bfloat16)
    vp = _randn(rs, (nb, bs, K, hd), cuda, torch.bfloat16)
    t = rs.permutation(np.arange(1, nb))[:B * maxblk].reshape(B, maxblk)
    t[1, :2] = t[0, :2]
    tables = torch.tensor(t, dtype=torch.int32, device=cuda)
    tol = 2e-5 if qdt == torch.float32 else 2e-2
    kw = dict(window=window, cap=cap)
    length = torch.tensor([1, 100, 192], dtype=torch.int32, device=cuda)
    _launch_and_compare(tpa.paged_decode_attention,
                        tpa.paged_decode_attention_plain,
                        (_randn(rs, (B, H, hd), cuda, qdt), kp, vp, tables,
                         length), kw, tol)
    _launch_and_compare(tpa.verify_attention, tpa.verify_attention_plain,
                        (_randn(rs, (B, 4, H, hd), cuda, qdt), kp, vp,
                         tables, torch.clamp(length, min=4)), kw, tol)
    start = torch.tensor([0, 41, 100], dtype=torch.int32, device=cuda)
    _launch_and_compare(tcp.chunk_prefill_attention,
                        tcp.chunk_prefill_attention_plain,
                        (_randn(rs, (B, 70, H, hd), cuda, qdt), kp, vp,
                         tables, start), kw, tol)


def test_paged_model_on_card_matches_cpu(cuda):
    """tiny-lite-llm (a sliding-window layer, paged linearly) over a paged
    pool: two prefill chunks (K5), a verify chunk (K3) and a decode step
    (K4) on the card against the CPU's plain versions, same weights;
    tolerance 5e-3 as in test_model_on_card_matches_cpu."""
    cfg = get_config("tiny-lite-llm")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    rs = np.random.RandomState(1)
    chunks = [rs.randint(0, cfg.vocab_size, (2, n)) for n in (40, 9, 4, 1)]
    tables = np.array([[3, 1, 7, 2, 9, 4, 11, 5],
                       [6, 8, 10, 12, 13, 14, 15, 16]], np.int32)
    outs = {}
    for dev in ("cpu", cuda):
        p = tree_to(params, dev)
        pool = kvc.init_paged_pool(cfg, 17, 8, device=dev)
        pos = torch.tensor([5, 2], device=dev)
        got = []
        with torch.inference_mode():
            for i, toks in enumerate(chunks):
                logits, _ = apply_model(
                    cfg, p, torch.as_tensor(toks, device=dev), pool, pos,
                    block_tables=torch.as_tensor(tables, device=dev),
                    verify=(i == 2))
                got.append(logits.float().cpu())
                pos = pos + toks.shape[1]
        outs[str(dev)] = got
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        torch.testing.assert_close(b, a, rtol=5e-3, atol=5e-3)
