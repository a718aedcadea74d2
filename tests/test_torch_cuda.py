"""On a CUDA card: the port's hand-written kernels against their plain
PyTorch versions, and the dense (GQA and RWKV-6) and paged model paths
through them against the same code on the CPU. Imports no JAX, so it
runs where only the port is installed:

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
from repro_torch.kernels import rwkv6_scan as tscan  # noqa: E402
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
@pytest.mark.parametrize("hd", [64, 128, 256])
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


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("window,cap", [(None, None), (100, 50.0)])
def test_kernels_lse_match_plain(cuda, qdt, hd, window, cap):
    """K1 and K2 with ``return_lse`` on a rank's slice of a sequence-split
    cache (negative local prefixes, a chunk past the slice, length 0):
    o as without it, each row's LSE within 1e-4, rows that see no key
    exactly o = 0 and lse = -inf."""
    B, Sq, H, K, T = 3, 96, 8, 2, 256
    rs = np.random.RandomState(9)
    q = _randn(rs, (B, Sq, H, hd), cuda, qdt)
    k = _randn(rs, (B, T, K, hd), cuda, torch.bfloat16)
    v = _randn(rs, (B, T, K, hd), cuda, torch.bfloat16)
    tol = 2e-5 if qdt == torch.float32 else 2e-2
    prefix = torch.tensor([-120, -30, 200], dtype=torch.int32, device=cuda)
    length = torch.tensor([0, 1, 256], dtype=torch.int32, device=cuda)
    for got, want in (
            (tfp.flash_prefill(q, k, v, prefix_len=prefix, window=window,
                               cap=cap, return_lse=True),
             tfp.flash_prefill_plain(q, k, v, prefix_len=prefix,
                                     window=window, cap=cap,
                                     return_lse=True)),
            (tdec.decode_attention(q[:, 0], k, v, length, window=window,
                                   cap=cap, return_lse=True),
             tdec.decode_attention_plain(q[:, 0], k, v, length,
                                         window=window, cap=cap,
                                         return_lse=True))):
        torch.cuda.synchronize()
        (o, lse), (o_p, lse_p) = got, want
        empty = torch.isneginf(lse_p)
        assert empty.any() and torch.equal(torch.isneginf(lse), empty)
        assert not torch.isnan(o).any() and (o.float()[empty] == 0).all()
        torch.testing.assert_close(o.float(), o_p.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(lse[~empty], lse_p[~empty], rtol=0,
                                   atol=1e-4)


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
@pytest.mark.parametrize("hd", [64, 128, 256])
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


def _scan_inputs(rs, B, S, H, hd, dev, dtype):
    """tests/test_kernels.py's distributions: r, k, v ~ N(0, 0.25), w in
    (0.4, 0.9), u ~ N(0, 0.01), state0 ~ N(0, 0.01)."""
    r, k, v = [_randn(rs, (B, S, H, hd), dev, torch.float32) * 0.5
               for _ in range(3)]
    w = torch.sigmoid(_randn(rs, (B, S, H, hd), dev, torch.float32)) * 0.5 \
        + 0.4
    u = _randn(rs, (H, hd), dev, torch.float32) * 0.1
    s0 = _randn(rs, (B, H, hd, hd), dev, torch.float32) * 0.1
    return [a.to(dtype) for a in (r, k, v, w)] + [u, s0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd", [(1, 64, 2, 32), (2, 128, 4, 64),
                                      (1, 96, 3, 64), (4, 1, 40, 64)])
def test_rwkv6_scan_matches_plain(cuda, dtype, B, S, H, hd):
    """K6 at tests/test_kernels.py's sweep shapes and one decode step at
    RWKV-6 3B's heads: y and the final state. Tolerance 2e-4 with fp32
    inputs (the summation order differs), 2e-2 with bf16 inputs (both
    sides read the same bf16 values; kept at the bf16 level of the other
    kernels)."""
    xs = _scan_inputs(np.random.RandomState(B * 10 + S), B, S, H, hd, cuda,
                      dtype)
    n0 = tscan.rwkv6_scan.launches
    y, st = tscan.rwkv6_scan(*xs)
    torch.cuda.synchronize()
    assert tscan.rwkv6_scan.launches == n0 + 1
    y_plain, st_plain = tscan.rwkv6_scan_plain(*xs)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y, y_plain, rtol=tol, atol=tol)
    torch.testing.assert_close(st, st_plain, rtol=tol, atol=tol)


def test_rwkv6_scan_in_place_state_and_carry(cuda):
    """The final state written over state0 (the engine's in-place cache
    update), and two halves with the carried state equal to one scan."""
    xs = _scan_inputs(np.random.RandomState(3), 2, 100, 4, 64, cuda,
                      torch.float32)
    y_full, s_full = tscan.rwkv6_scan(*xs)
    state = xs[5].clone()
    y1, s1 = tscan.rwkv6_scan(*[a[:, :37].contiguous() for a in xs[:4]],
                              xs[4], state, out_state=state)
    assert s1 is state
    y2, s2 = tscan.rwkv6_scan(*[a[:, 37:].contiguous() for a in xs[:4]],
                              xs[4], state, out_state=state)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(state, s_full, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="contiguous"):
        tscan.rwkv6_scan(*[a[:, ::2] for a in xs[:4]], xs[4], xs[5])


def test_rwkv_model_on_card_matches_cpu(cuda):
    """Reduced RWKV-6 (hd 32): prefill 16 then 3 decode steps on a dense
    recurrent cache, on the card (K6 once per layer per forward) against
    the CPU; logits and every cache leaf within 1e-3 (fp32 throughout;
    the card's matmuls sum in another order)."""
    cfg = get_config("rwkv6-3b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 19))
    sched = [(0, 16), (16, 17), (17, 18), (18, 19)]
    outs = {}
    for dev in ("cpu", cuda):
        p = tree_to(params, dev)
        cache = kvc.init_cache(cfg, 2, 64, device=dev)
        n0 = tscan.rwkv6_scan.launches
        got = []
        with torch.inference_mode():
            for lo, hi in sched:
                logits, cache = apply_model(
                    cfg, p, torch.as_tensor(toks[:, lo:hi], device=dev),
                    cache, lo)
                got.append(logits.float().cpu())
        got += [t.float().cpu() for t in cache["stages"][0][0].values()]
        outs[str(dev)] = got
        layers = cfg.stages[0].repeat
        assert tscan.rwkv6_scan.launches - n0 == \
            (0 if dev == "cpu" else layers * len(sched))
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-3)


def test_paged_pool_refuses_rwkv():
    """Recurrent state is per sequence, not per token: the paged pool
    refuses RWKV layers, as the reference's does (no card needed: it
    raises before allocating)."""
    with pytest.raises(ValueError, match="rwkv"):
        kvc.init_paged_pool(get_config("rwkv6-3b"), 8, 16)


# ---------------------------------------------------------------------------
# K2 / K3 split-KV kernels: chunk edges, CUDA-graph capture, host threads

EDGE_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 511, 512]


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("T", [512, 200])
@pytest.mark.parametrize("window,cap", [(None, None), (100, 50.0)])
def test_split_decode_at_chunk_edges(cuda, qdt, hd, T, window, cap):
    """K2 with G = 16 (its largest group) at lengths on and beside the
    64-key split edges, over a full 512-slot cache and a ragged T = 200
    (the last split masked), against its plain version."""
    lengths = [min(n, T) for n in EDGE_LENGTHS]
    B, K = len(lengths), 2
    rs = np.random.RandomState(20)
    q = _randn(rs, (B, 16 * K, hd), cuda, qdt)
    k = _randn(rs, (B, T, K, hd), cuda, torch.bfloat16)
    v = _randn(rs, (B, T, K, hd), cuda, torch.bfloat16)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    _launch_and_compare(tdec.decode_attention, tdec.decode_attention_plain,
                  (q, k, v, ln), dict(window=window, cap=cap),
                  2e-5 if qdt == torch.float32 else 2e-2)


def _verify_inputs(rs, B, Sq, H, K, hd, bs, maxblk, dev, qdt):
    """A bf16 pool with shuffled physical blocks, rows 0 and 1 sharing
    their first two blocks as a copy-on-write fork does."""
    nb = B * maxblk + 1
    kp = _randn(rs, (nb, bs, K, hd), dev, torch.bfloat16)
    vp = _randn(rs, (nb, bs, K, hd), dev, torch.bfloat16)
    t = rs.permutation(np.arange(1, nb))[:B * maxblk].reshape(B, maxblk)
    t[1, :2] = t[0, :2]
    q = _randn(rs, (B, Sq, H, hd), dev, qdt)
    return q, kp, vp, torch.tensor(t, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("bs,maxblk", [(16, 32), (8, 25)])
@pytest.mark.parametrize("window,cap", [(None, None), (100, 50.0)])
@pytest.mark.parametrize("Sq,G", [(8, 8), (4, 16)])
def test_split_verify_at_chunk_edges(cuda, qdt, hd, bs, maxblk, window, cap,
                                     Sq, G):
    """K3 with R = Sq * G = 64 rows (its most) at total lengths on and
    beside the split edges (at least Sq: the chunk's own positions are in
    the cache), over 512 keys and a ragged 200, against its plain
    version."""
    span = bs * maxblk
    lengths = [max(Sq, min(n, span)) for n in EDGE_LENGTHS]
    B, K = len(lengths), 2
    q, kp, vp, t = _verify_inputs(np.random.RandomState(21), B, Sq, G * K,
                                  K, hd, bs, maxblk, cuda, qdt)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    _launch_and_compare(tpa.verify_attention, tpa.verify_attention_plain,
                  (q, kp, vp, t, ln), dict(window=window, cap=cap),
                  2e-5 if qdt == torch.float32 else 2e-2)


def test_split_kernels_in_a_cuda_graph(cuda):
    """K2 and K3 captured in one CUDA graph, then replayed after their
    length tensors are rewritten in place: each replay equals an eager
    call on the new lengths bit for bit, and the plain version within
    2e-5. So the wrappers read no length on the host, and the per-call
    workspace is valid under capture."""
    rs = np.random.RandomState(22)
    B, H, K, hd, T = 4, 32, 4, 64, 512
    q = _randn(rs, (B, H, hd), cuda, torch.float32)
    k = _randn(rs, (B, T, K, hd), cuda, torch.bfloat16)
    v = _randn(rs, (B, T, K, hd), cuda, torch.bfloat16)
    qv, kp, vp, t = _verify_inputs(rs, B, 4, H, K, hd, 16, 32, cuda,
                                   torch.float32)
    ln_d = torch.tensor([1, 130, 300, 512], dtype=torch.int32, device=cuda)
    ln_v = torch.tensor([4, 130, 300, 512], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # build, attributes, allocator
        tdec.decode_attention(q, k, v, ln_d)
        tpa.verify_attention(qv, kp, vp, t, ln_v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        od = tdec.decode_attention(q, k, v, ln_d)
        ov = tpa.verify_attention(qv, kp, vp, t, ln_v)
    for new_d, new_v in (([64, 65, 511, 2], [64, 65, 511, 5]),
                         ([512, 1, 129, 63], [512, 8, 129, 63])):
        ln_d.copy_(torch.tensor(new_d, dtype=torch.int32))
        ln_v.copy_(torch.tensor(new_v, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(od, tdec.decode_attention(q, k, v, ln_d))
        assert torch.equal(ov, tpa.verify_attention(qv, kp, vp, t, ln_v))
        torch.testing.assert_close(
            od, tdec.decode_attention_plain(q, k, v, ln_d), rtol=2e-5,
            atol=2e-5)
        torch.testing.assert_close(
            ov, tpa.verify_attention_plain(qv, kp, vp, t, ln_v), rtol=2e-5,
            atol=2e-5)


def test_split_verify_from_two_host_threads(cuda):
    """Two host threads call K3 200 times each on different inputs onto
    one stream, as the engines do; every result equals its plain version,
    so no call's partials reach another call's combine."""
    import threading
    cases = []
    for seed, lengths in ((23, [4, 200, 377, 512]), (24, [512, 64, 9, 300])):
        q, kp, vp, t = _verify_inputs(np.random.RandomState(seed), 4, 4,
                                      32, 4, 64, 16, 32, cuda,
                                      torch.float32)
        ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        cases.append((q, kp, vp, t, ln))
    wants = [tpa.verify_attention_plain(*c) for c in cases]
    outs = [[], []]

    def work(i):
        for _ in range(200):
            outs[i].append(tpa.verify_attention(*cases[i]))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    for want, got in zip(wants, outs):
        assert len(got) == 200
        for o in got:
            torch.testing.assert_close(o, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# K4 paged decode on the split-KV template

@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("bs,maxblk", [(16, 32), (8, 25)])
@pytest.mark.parametrize("window,cap", [(None, None), (100, 50.0)])
def test_paged_decode_at_chunk_edges(cuda, qdt, hd, bs, maxblk, window, cap):
    """K4 with G = 16 (its largest group) at lengths on and beside the
    64-key split edges, over 512 keys and a ragged 200, on a shuffled pool
    whose rows 0 and 1 share their first two blocks."""
    span = bs * maxblk
    lengths = [min(n, span) for n in EDGE_LENGTHS]
    B, K = len(lengths), 2
    q, kp, vp, t = _verify_inputs(np.random.RandomState(30), B, 1, 16 * K,
                                  K, hd, bs, maxblk, cuda, qdt)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    _launch_and_compare(tpa.paged_decode_attention,
                        tpa.paged_decode_attention_plain,
                        (q[:, 0], kp, vp, t, ln),
                        dict(window=window, cap=cap),
                        2e-5 if qdt == torch.float32 else 2e-2)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_paged_decode_reads_no_out_of_table_key(cuda, qdt):
    """Table entries past each row's length point at the pad block, which
    is poisoned with NaN (as are the unused blocks): K4 reads only the
    rows of visible keys, so its result is finite and equals the plain
    version on the unpoisoned pool."""
    rs = np.random.RandomState(31)
    B, H, K, hd, bs, maxblk = 4, 32, 4, 64, 16, 32
    q, kp, vp, t = _verify_inputs(rs, B, 1, H, K, hd, bs, maxblk, cuda, qdt)
    lengths = [1, 63, 130, 300]
    t = t.clone()
    for b, n in enumerate(lengths):
        t[b, -(-n // bs):] = kvc.PAD_BLOCK
    used = torch.zeros(kp.shape[0], dtype=torch.bool, device=cuda)
    for b, n in enumerate(lengths):
        used[t[b, :-(-n // bs)].long()] = True
    kp_bad, vp_bad = kp.clone(), vp.clone()
    kp_bad[~used] = float("nan")
    vp_bad[~used] = float("nan")
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    o = tpa.paged_decode_attention(q[:, 0], kp_bad, vp_bad, t, ln)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all()
    tol = 2e-5 if qdt == torch.float32 else 2e-2
    torch.testing.assert_close(
        o.float(), tpa.paged_decode_attention_plain(q[:, 0], kp, vp, t,
                                                    ln).float(),
        rtol=tol, atol=tol)


def test_paged_decode_in_a_cuda_graph(cuda):
    """K4 captured in a CUDA graph, then replayed after its length tensor
    is rewritten in place: each replay equals an eager call bit for bit
    and the plain version within 2e-5."""
    q, kp, vp, t = _verify_inputs(np.random.RandomState(32), 4, 1, 32, 4,
                                  64, 16, 32, cuda, torch.float32)
    q = q[:, 0].contiguous()
    ln = torch.tensor([1, 130, 300, 512], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # build, attributes, allocator
        tpa.paged_decode_attention(q, kp, vp, t, ln)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.paged_decode_attention(q, kp, vp, t, ln)
    for new in ([64, 65, 511, 2], [512, 1, 129, 63]):
        ln.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tpa.paged_decode_attention(q, kp, vp, t, ln))
        torch.testing.assert_close(
            out, tpa.paged_decode_attention_plain(q, kp, vp, t, ln),
            rtol=2e-5, atol=2e-5)


def test_paged_decode_from_two_host_threads(cuda):
    """Two host threads call K4 200 times each on different inputs onto
    one stream; every result equals its plain version."""
    import threading
    cases = []
    for seed, lengths in ((33, [4, 200, 377, 512]), (34, [512, 64, 9, 300])):
        q, kp, vp, t = _verify_inputs(np.random.RandomState(seed), 4, 1, 32,
                                      4, 64, 16, 32, cuda, torch.float32)
        ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        cases.append((q[:, 0].contiguous(), kp, vp, t, ln))
    wants = [tpa.paged_decode_attention_plain(*c) for c in cases]
    outs = [[], []]

    def work(i):
        for _ in range(200):
            outs[i].append(tpa.paged_decode_attention(*cases[i]))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    for want, got in zip(wants, outs):
        assert len(got) == 200
        for o in got:
            torch.testing.assert_close(o, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# K1 flash_prefill on the tensor cores

def _prefill_inputs(rs, B, Sq, G, K, hd, T, dev, qdt, kvdt=torch.bfloat16,
                    qk_scale=1.0):
    q = _randn(rs, (B, Sq, G * K, hd), dev, qdt) * qk_scale
    k = _randn(rs, (B, T, K, hd), dev, kvdt) * qk_scale
    v = _randn(rs, (B, T, K, hd), dev, kvdt)
    return q.to(qdt), k.to(kvdt), v


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_flash_prefill_tc_matches_plain(cuda, qdt, hd, G):
    """K1 at every group size the GQA packing takes (128 / G positions per
    CTA) and ragged chunks (Sq 1, 17, 64, 200, 256) at per-sequence
    prefixes, over a 512-slot cache, against its plain version."""
    rs = np.random.RandomState(40 + G + hd)
    for Sq in (1, 17, 64, 200, 256):
        q, k, v = _prefill_inputs(rs, 3, Sq, G, 2, hd, 512, cuda, qdt)
        prefix = torch.tensor([0, 41, 512 - Sq - 3], dtype=torch.int32,
                              device=cuda)
        _launch_and_compare(tfp.flash_prefill, tfp.flash_prefill_plain,
                            (q, k, v), dict(prefix_len=prefix),
                            2e-5 if qdt == torch.float32 else 2e-2)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_prefill_tc_window_softcap(cuda, qdt, hd):
    """A window that empties the long rows' leading tiles, and a softcap,
    at G = 8 and a ragged Sq."""
    q, k, v = _prefill_inputs(np.random.RandomState(50 + hd), 3, 150, 8, 2,
                              hd, 512, cuda, qdt)
    prefix = torch.tensor([0, 77, 300], dtype=torch.int32, device=cuda)
    _launch_and_compare(tfp.flash_prefill, tfp.flash_prefill_plain,
                        (q, k, v), dict(prefix_len=prefix, window=100,
                                        cap=50.0),
                        2e-5 if qdt == torch.float32 else 2e-2)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_prefill_fp32_kv(cuda, qdt, hd):
    """fp32 K/V (dispatched, stored by no engine) take the CUDA-core body
    and meet the same tolerances."""
    q, k, v = _prefill_inputs(np.random.RandomState(60 + hd), 3, 96, 4, 2,
                              hd, 256, cuda, qdt, kvdt=torch.float32)
    prefix = torch.tensor([0, 41, 160], dtype=torch.int32, device=cuda)
    _launch_and_compare(tfp.flash_prefill, tfp.flash_prefill_plain,
                        (q, k, v), dict(prefix_len=prefix),
                        2e-5 if qdt == torch.float32 else 2e-2)


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_prefill_tc_at_three_times_scale(cuda, hd):
    """q, k ~ 3 N(0, 1): scores reach ~40, where fp32 rounding alone moves
    a probability by ~4e-6, and the fp32 plain version computed on the
    card is itself 1.5-2.8e-5 from float64 (measured on the H100). So the
    kernel is held to 2e-5 of the plain version evaluated in float64, and
    must be closer to it than the fp32 plain version is."""
    q, k, v = _prefill_inputs(np.random.RandomState(70 + hd), 4, 256, 8, 4,
                              hd, 512, cuda, torch.float32, qk_scale=3.0)
    kw = dict(prefix_len=torch.tensor([0, 37, 100, 200], dtype=torch.int32,
                                      device=cuda))
    n0 = tfp.flash_prefill.launches
    o = tfp.flash_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfp.flash_prefill.launches == n0 + 1
    truth = tfp.flash_prefill_plain(q.double(), k.double(), v.double(), **kw)
    err = (o.double() - truth).abs().max().item()
    err32 = (tfp.flash_prefill_plain(q, k, v, **kw).double()
             - truth).abs().max().item()
    assert err <= 2e-5 and err < err32, (err, err32)


# ---------------------------------------------------------------------------
# K5 chunk_prefill on the tensor-core tile kernel (flash_tile.cuh)

CHUNK_STARTS = (0, 15, 16, 63, 64, 65)    # on and beside 16- and 64-key edges


def _chunk_inputs(rs, B, Sq, G, K, hd, bs, dev, qdt, kvdt=torch.bfloat16,
                  qk_scale=1.0, span=512):
    """q (B, Sq, G*K, hd) and a pool of 1 + B * span / bs blocks, block 0
    the pad block, each sequence's span / bs blocks shuffled over the
    rest."""
    maxblk = span // bs
    nb = 1 + B * maxblk
    q = _randn(rs, (B, Sq, G * K, hd), dev, torch.float32) * qk_scale
    kp = _randn(rs, (nb, bs, K, hd), dev, torch.float32) * qk_scale
    vp = _randn(rs, (nb, bs, K, hd), dev, torch.float32)
    t = rs.permutation(np.arange(1, nb)).reshape(B, maxblk)
    return (q.to(qdt), kp.to(kvdt), vp.to(kvdt),
            torch.tensor(t, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
@pytest.mark.parametrize("bs", [16, 32])
def test_chunk_prefill_tc_matches_plain(cuda, qdt, hd, G, bs):
    """K5 at group sizes 1-16 (128 / G chunk positions per CTA), ragged
    chunks (Sq 1, 17, 64, 128) at starts on and beside the 16- and 64-key
    edges and at the end of a 512-key span, over a shuffled pool with
    blocks of 16 or 32, against its plain version."""
    rs = np.random.RandomState(80 + G + hd + bs)
    for Sq in (1, 17, 64, 128):
        q, kp, vp, t = _chunk_inputs(rs, 7, Sq, G, 2, hd, bs, cuda, qdt)
        start = torch.tensor(CHUNK_STARTS + (512 - Sq,), dtype=torch.int32,
                             device=cuda)
        _launch_and_compare(tcp.chunk_prefill_attention,
                            tcp.chunk_prefill_attention_plain,
                            (q, kp, vp, t, start), {},
                            2e-5 if qdt == torch.float32 else 2e-2)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_chunk_prefill_tc_window_softcap(cuda, qdt, hd):
    """A window that empties the long rows' leading tiles, and a softcap,
    at G = 8 and a ragged Sq."""
    q, kp, vp, t = _chunk_inputs(np.random.RandomState(90 + hd), 4, 100, 8,
                                 2, hd, 16, cuda, qdt)
    start = torch.tensor([0, 37, 150, 400], dtype=torch.int32, device=cuda)
    _launch_and_compare(tcp.chunk_prefill_attention,
                        tcp.chunk_prefill_attention_plain,
                        (q, kp, vp, t, start), dict(window=100, cap=50.0),
                        2e-5 if qdt == torch.float32 else 2e-2)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_chunk_prefill_fp32_pool(cuda, qdt, hd):
    """fp32 pools (dispatched, stored by no engine) take the CUDA-core body
    and meet the same tolerances."""
    q, kp, vp, t = _chunk_inputs(np.random.RandomState(95 + hd), 3, 70, 4,
                                 2, hd, 16, cuda, qdt, kvdt=torch.float32,
                                 span=256)
    start = torch.tensor([0, 41, 186], dtype=torch.int32, device=cuda)
    _launch_and_compare(tcp.chunk_prefill_attention,
                        tcp.chunk_prefill_attention_plain,
                        (q, kp, vp, t, start), {},
                        2e-5 if qdt == torch.float32 else 2e-2)


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_chunk_prefill_tc_at_three_times_scale(cuda, hd):
    """q, k ~ 3 N(0, 1), as for K1: the kernel is held to 2e-5 of the plain
    version evaluated in float64, and must be closer to it than the fp32
    plain version is."""
    q, kp, vp, t = _chunk_inputs(np.random.RandomState(100 + hd), 4, 128, 8,
                                 4, hd, 16, cuda, torch.float32,
                                 qk_scale=3.0)
    start = torch.tensor([0, 37, 100, 200], dtype=torch.int32, device=cuda)
    n0 = tcp.chunk_prefill_attention.launches
    o = tcp.chunk_prefill_attention(q, kp, vp, t, start)
    torch.cuda.synchronize()
    assert tcp.chunk_prefill_attention.launches == n0 + 1
    truth = tcp.chunk_prefill_attention_plain(q.double(), kp.double(),
                                              vp.double(), t, start)
    err = (o.double() - truth).abs().max().item()
    err32 = (tcp.chunk_prefill_attention_plain(q, kp, vp, t, start).double()
             - truth).abs().max().item()
    assert err <= 2e-5 and err < err32, (err, err32)


def test_tile_kernels_in_a_cuda_graph(cuda):
    """K5 and K1 (one tile kernel, two addressing types) captured in one
    CUDA graph, then replayed after q, the chunk starts, the block table
    and the prefixes are rewritten in place: each replay equals an eager
    call on the new inputs bit for bit."""
    rs = np.random.RandomState(110)
    q, kp, vp, t = _chunk_inputs(rs, 4, 128, 8, 4, 64, 16, cuda,
                                 torch.float32)
    start = torch.tensor([0, 37, 100, 200], dtype=torch.int32, device=cuda)
    q1 = _randn(rs, (4, 64, 32, 64), cuda, torch.float32)
    k1 = _randn(rs, (4, 512, 4, 64), cuda, torch.bfloat16)
    v1 = _randn(rs, (4, 512, 4, 64), cuda, torch.bfloat16)
    pre = torch.tensor([0, 37, 100, 200], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # build, attributes, allocator
        tcp.chunk_prefill_attention(q, kp, vp, t, start)
        tfp.flash_prefill(q1, k1, v1, prefix_len=pre)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o5 = tcp.chunk_prefill_attention(q, kp, vp, t, start)
        o1 = tfp.flash_prefill(q1, k1, v1, prefix_len=pre)
    for new_start, new_pre in (([384, 1, 64, 250], [448, 0, 65, 300]),
                               ([16, 300, 0, 63], [1, 200, 447, 63])):
        q.copy_(_randn(rs, tuple(q.shape), cuda, torch.float32))
        q1.copy_(_randn(rs, tuple(q1.shape), cuda, torch.float32))
        t.copy_(t[torch.randperm(4, device=cuda)])
        start.copy_(torch.tensor(new_start, dtype=torch.int32))
        pre.copy_(torch.tensor(new_pre, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(o5, tcp.chunk_prefill_attention(q, kp, vp, t,
                                                           start))
        assert torch.equal(o1, tfp.flash_prefill(q1, k1, v1,
                                                 prefix_len=pre))


@pytest.mark.parametrize("hd", [96, 512])
def test_wrappers_refuse_other_head_dims(cuda, hd):
    """Head dims outside (64, 128, 256) raise on the card before any
    launch: K1-K5 have no instantiation for them."""
    rs = np.random.RandomState(119)
    q = _randn(rs, (2, 8, 4, hd), cuda, torch.float32)
    k = _randn(rs, (2, 64, 2, hd), cuda, torch.bfloat16)
    kp = _randn(rs, (9, 16, 2, hd), cuda, torch.bfloat16)
    t = torch.arange(1, 9, dtype=torch.int32, device=cuda).reshape(2, 4)
    n = torch.tensor([8, 30], dtype=torch.int32, device=cuda)
    calls = ((tfp.flash_prefill, (q, k, k)),
             (tdec.decode_attention, (q[:, 0], k, k, n)),
             (tpa.paged_decode_attention, (q[:, 0], kp, kp, t, n)),
             (tpa.verify_attention, (q[:, :4], kp, kp, t, n)),
             (tcp.chunk_prefill_attention, (q, kp, kp, t, n)))
    for fn, args in calls:
        n0 = fn.launches
        with pytest.raises(ValueError, match="head dim"):
            fn(*args)
        assert fn.launches == n0, fn.__name__


def test_hd256_kernels_in_a_cuda_graph(cuda):
    """K1-K5 at Gemma-2's heads (H 16, K 8, hd 256: one 64-row warpgroup
    per tile CTA) captured in one CUDA graph, then replayed after their
    positions are rewritten in place: each replay equals an eager call on
    the new positions bit for bit, and the plain version within 2e-5."""
    rs = np.random.RandomState(120)
    B, H, K, hd, T = 4, 16, 8, 256, 512
    q1 = _randn(rs, (B, 64, H, hd), cuda, torch.float32)
    q2 = _randn(rs, (B, H, hd), cuda, torch.float32)
    k = _randn(rs, (B, T, K, hd), cuda, torch.bfloat16)
    v = _randn(rs, (B, T, K, hd), cuda, torch.bfloat16)
    qv, kp, vp, t = _verify_inputs(rs, B, 4, H, K, hd, 16, 32, cuda,
                                   torch.float32)
    q4 = _randn(rs, (B, H, hd), cuda, torch.float32)
    q5 = _randn(rs, (B, 64, H, hd), cuda, torch.float32)
    pre = torch.tensor([0, 37, 100, 200], dtype=torch.int32, device=cuda)
    ln = torch.tensor([4, 130, 300, 512], dtype=torch.int32, device=cuda)
    start = torch.tensor([0, 37, 100, 200], dtype=torch.int32, device=cuda)
    calls = (
        (tfp.flash_prefill, tfp.flash_prefill_plain, (q1, k, v),
         dict(prefix_len=pre, cap=50.0)),
        (tdec.decode_attention, tdec.decode_attention_plain,
         (q2, k, v, ln), dict(window=64)),
        (tpa.verify_attention, tpa.verify_attention_plain,
         (qv, kp, vp, t, ln), {}),
        (tpa.paged_decode_attention, tpa.paged_decode_attention_plain,
         (q4, kp, vp, t, ln), dict(cap=50.0)),
        (tcp.chunk_prefill_attention, tcp.chunk_prefill_attention_plain,
         (q5, kp, vp, t, start), dict(window=64)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # build, attributes, allocator
        for fn, _, args, kw in calls:
            fn(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*args, **kw) for fn, _, args, kw in calls]
    for new_pre, new_ln, new_start in (
            ([448, 0, 65, 300], [64, 65, 511, 5], [384, 1, 64, 250]),
            ([1, 200, 447, 63], [512, 8, 129, 63], [16, 300, 0, 63])):
        pre.copy_(torch.tensor(new_pre, dtype=torch.int32))
        ln.copy_(torch.tensor(new_ln, dtype=torch.int32))
        start.copy_(torch.tensor(new_start, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        for o, (fn, plain, args, kw) in zip(outs, calls):
            assert torch.equal(o, fn(*args, **kw)), fn.__name__
            torch.testing.assert_close(o, plain(*args, **kw), rtol=2e-5,
                                       atol=2e-5)


# ---------------------------------------------------------------------------
# K6 rwkv6_scan as a column-split recurrence

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S", [1, 2, 31, 32, 33, 63, 64, 65, 512])
def test_rwkv6_scan_colsplit_matches_plain(cuda, dtype, hd, S):
    """K6 at lengths on and beside its 16-step chunk edges (the decode
    kernel at S = 1), y and the final state against the plain
    version; tolerances as in test_rwkv6_scan_matches_plain."""
    xs = _scan_inputs(np.random.RandomState(S * 3 + hd), 2, S, 3, hd, cuda,
                      dtype)
    n0 = tscan.rwkv6_scan.launches
    y, st = tscan.rwkv6_scan(*xs)
    torch.cuda.synchronize()
    assert tscan.rwkv6_scan.launches == n0 + 1
    y_plain, st_plain = tscan.rwkv6_scan_plain(*xs)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y, y_plain, rtol=tol, atol=tol)
    torch.testing.assert_close(st, st_plain, rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [32, 64])
def test_rwkv6_scan_aliased_carry_equals_one_call(cuda, hd):
    """A prefill in two chunks (37 + 27 steps) then 5 decode steps, each
    writing its state over state0 (the engine's in-place cache), equal one
    69-step call within 1e-4."""
    xs = _scan_inputs(np.random.RandomState(120 + hd), 2, 69, 4, hd, cuda,
                      torch.float32)
    y_one, s_one = tscan.rwkv6_scan(*xs)
    state = xs[5].clone()
    ys = []
    for lo, hi in [(0, 37), (37, 64)] + [(64 + i, 65 + i) for i in range(5)]:
        y, s = tscan.rwkv6_scan(*[a[:, lo:hi].contiguous() for a in xs[:4]],
                                xs[4], state, out_state=state)
        assert s is state
        ys.append(y)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat(ys, 1), y_one, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(state, s_one, rtol=1e-4, atol=1e-4)


def test_rwkv6_scan_in_a_cuda_graph(cuda):
    """A 40-step prefill and a decode step of K6, both updating one state
    in place, captured in a CUDA graph, then replayed after every input
    and the state are rewritten in place: each replay equals eager
    execution on the same inputs bit for bit."""
    rs = np.random.RandomState(130)
    pre = _scan_inputs(rs, 4, 40, 40, 64, cuda, torch.float32)
    dec = _scan_inputs(rs, 4, 1, 40, 64, cuda, torch.float32)
    u, state = pre[4], pre[5]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # build, allocator
        tscan.rwkv6_scan(*pre[:4], u, state.clone())
        tscan.rwkv6_scan(*dec[:4], u, state.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_pre, _ = tscan.rwkv6_scan(*pre[:4], u, state, out_state=state)
        y_dec, _ = tscan.rwkv6_scan(*dec[:4], u, state, out_state=state)
    for seed in (131, 132):
        new = _scan_inputs(np.random.RandomState(seed), 4, 41, 40, 64, cuda,
                           torch.float32)
        for a, b in zip(pre[:4], new[:4]):
            a.copy_(b[:, :40])
        for a, b in zip(dec[:4], new[:4]):
            a.copy_(b[:, 40:])
        u.copy_(new[4])
        state.copy_(new[5])
        graph.replay()
        torch.cuda.synchronize()
        s = new[5].clone()
        want_pre, _ = tscan.rwkv6_scan(*pre[:4], u, s, out_state=s)
        want_dec, _ = tscan.rwkv6_scan(*dec[:4], u, s, out_state=s)
        assert torch.equal(y_pre, want_pre)
        assert torch.equal(y_dec, want_dec)
        assert torch.equal(state, s)


# ---------------------------------------------------------------------------
# the serving layers' pool operations on the card

def _card_pool(cfg, nb, bs, dev, stamp=False):
    """A paged pool on the card; with ``stamp`` every cell holds its own
    block id."""
    pool = kvc.init_paged_pool(cfg, nb, bs, device=dev)
    if stamp:
        for a in kvc._pool_arrays(pool):
            ids = torch.arange(a.shape[1], dtype=a.dtype, device=dev)
            a.copy_(ids.reshape((1, -1) + (1,) * (a.ndim - 2)).expand_as(a))
    return pool


def test_migrate_blocks_between_pools_on_the_card(cuda):
    """The blocks' data moves, refcounts are conserved (shared source
    blocks survive), and a full destination leaves both allocators and
    the destination's data untouched."""
    cfg = get_config("tiny-lite-llm")
    sa, da = kvc.BlockAllocator(16), kvc.BlockAllocator(16)
    src = _card_pool(cfg, 16, 8, cuda, stamp=True)
    dst = _card_pool(cfg, 16, 8, cuda)
    table = kvc.reserve_blocks(sa, 5)
    sa.incref(table[1])                       # co-owned, e.g. by a radix
    dst_table, out = kvc.migrate_blocks(sa, src, da, dst, table)
    torch.cuda.synchronize()
    assert out is dst and len(set(dst_table)) == 5
    assert [sa.refcount(b) for b in table] == [0, 1, 0, 0, 0]
    assert all(da.refcount(b) == 1 for b in dst_table)
    for a in kvc._pool_arrays(dst):
        for s, d in zip(table, dst_table):
            assert bool((a[:, d] == float(s)).all())
    small = kvc.BlockAllocator(4)             # 3 blocks, 2 of them held
    held = kvc.reserve_blocks(small, 2)
    full = _card_pool(cfg, 4, 8, cuda)
    before = [a.clone() for a in kvc._pool_arrays(full)]
    table2 = kvc.reserve_blocks(sa, 3)
    refs = sa.refs_snapshot(), small.refs_snapshot()
    with pytest.raises(kvc.OutOfBlocks):
        kvc.migrate_blocks(sa, src, small, full, table2)
    assert (sa.refs_snapshot(), small.refs_snapshot()) == refs
    assert small.free_blocks() == small.capacity - len(held)
    for a, b in zip(kvc._pool_arrays(full), before):
        assert torch.equal(a, b)


def _seq_kv(eng, st):
    """The sequence's K/V rows [0, pos) of every pool array, gathered
    through its block table, as float32 on the host."""
    idx = torch.tensor(st.table, dtype=torch.long, device=eng.device)
    out = []
    for a in kvc._pool_arrays(eng.pool):
        rows = a.index_select(1, idx)
        rows = rows.reshape(a.shape[0], -1, *a.shape[3:])[:, :st.pos]
        out.append(rows.float().cpu())
    return out


def test_paged_preemption_replay_rewrites_the_kv_on_the_card(cuda):
    """Evict-to-recompute on the card: preemption frees every block of the
    sequence, the replay on re-admission (the prompt, then the emitted
    tokens teacher-forced, through the prefill kernel) writes K/V equal
    to those written before preemption within bf16 rounding, and the
    continuation is the unpreempted run's."""
    from repro_torch.engines.decode_loop import DecodeSeq
    from repro_torch.engines.llm_engine import LLMEngine
    from repro_torch.serving.slo import attach_slo

    def fresh():
        eng = LLMEngine("t", get_config("tiny-lite-llm"), max_len=128,
                        max_batch=4, paged=True, block_size=8, num_blocks=64,
                        device=cuda)
        attach_slo({"llm": eng}, preempt_cooldown_s=0.0)
        eng.op_prefill([{"sid": "s", "text":
                         "some moderately long prompt words here"}])
        seq = DecodeSeq("s", eng.states["s"], 10,
                        text_fn=lambda q: eng.tok.decode(q.tokens))
        assert eng.try_admit(seq)
        eng.note_slot_acquired(seq)
        return eng, seq

    def drive(eng, seq, iters):
        for _ in range(iters):
            before = len(seq.tokens)
            eng.decode_iteration([seq])
            seq.steps += max(1, len(seq.tokens) - before)

    eng0, base = fresh()
    drive(eng0, base, 10)
    eng, seq = fresh()
    drive(eng, seq, 4)
    kv_before, pos = _seq_kv(eng, seq.state), seq.state.pos
    free0 = eng.alloc.free_blocks()
    eng.preempt_decode(seq)
    assert seq.state.pos == 0 and not seq.state.table
    assert eng.alloc.free_blocks() > free0
    assert eng.try_admit(seq)
    eng.note_slot_acquired(seq)
    n5 = tcp.chunk_prefill_attention.launches
    eng._slo_resume(seq)
    torch.cuda.synchronize()
    assert tcp.chunk_prefill_attention.launches > n5
    assert seq.state.pos == pos
    for a, b in zip(_seq_kv(eng, seq.state), kv_before):
        torch.testing.assert_close(a, b, rtol=1e-2, atol=1e-2)
    drive(eng, seq, 6)
    assert seq.tokens == base.tokens
    eng.note_slot_released(seq)
    eng.release("s")
    assert eng.alloc.audit()["ok"]
    assert eng.alloc.free_blocks() == eng.alloc.capacity


def test_reclaim_replica_on_a_card_pool_with_live_sequences(cuda):
    from repro_torch.engines.llm_engine import LLMEngine
    eng = LLMEngine("p", get_config("tiny-lite-llm"), max_len=256,
                    paged=True, block_size=8, num_blocks=32,
                    prefix_cache="radix", device=cuda)
    text = " ".join(f"w{i}" for i in range(16))
    eng.op_prefill([{"sid": "s0", "text": text + " alpha"},
                    {"sid": "s1", "text": text + " beta"}])
    seq = eng.submit_decode("s1", 4)
    assert seq.wait(120)
    eng.stop_decode_loop()
    assert eng.alloc.used_blocks() > 0 and eng.radix.num_blocks() > 0
    report = kvc.reclaim_replica(eng)
    assert report["ok"] and report["leaked"] == 0
    assert report["released"] == 2 and report["radix_refs"] > 0
    assert eng.alloc.free_blocks() == eng.alloc.capacity
    assert eng.alloc.audit()["ok"] and eng.states == {}


# ---------------------------------------------------------------------------
# the other architectures: MoE dispatch, MLA paged, reduced engines

def test_moe_dispatch_on_card_matches_all_experts(cuda):
    """Both forms of the selected-pairs dispatch (the grouped kernel, and
    the sorted per-expert products with their host sync) against the
    reference's all-experts formulation (``routed_dense_plain``) on the
    card, at Qwen1.5-MoE's router (60 experts, top 4) and a narrow width,
    4 and 64 tokens; the same routing on both sides (one router call each
    on the same inputs). Outputs at 1e-5 of their scale, the aux loss at
    1e-5; the grouped form launches the kernel once a call."""
    import dataclasses
    from repro_torch.kernels import moe_experts as tmx
    from repro_torch.models import moe
    base = get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(base, d_model=256, moe=dataclasses.replace(
        base.moe, d_expert=128, d_shared=256))
    p = moe.init_moe_params(torch.Generator(device=cuda).manual_seed(0),
                            cfg, torch.float32, cuda, 1)
    p = {k: (v[0] if torch.is_tensor(v) else
             {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    limit = moe.GROUPED_MAX_ASSIGN
    for T in (4, 64):
        x = torch.randn((T, 256), generator=torch.Generator(
            device=cuda).manual_seed(T), device=cuda)
        for path in ("grouped", "sorted"):
            moe.GROUPED_MAX_ASSIGN = 1 << 30 if path == "grouped" else 0
            n0 = tmx.moe_experts.launches
            try:
                with torch.inference_mode():
                    got, aux = moe.routed(cfg, p, x)
                    want, aux_w = moe.routed_dense_plain(cfg, p, x)
                    full, _ = moe.moe_ffn(cfg, p, x[None])
            finally:
                moe.GROUPED_MAX_ASSIGN = limit
            assert tmx.moe_experts.launches - n0 == \
                (2 if path == "grouped" else 0)
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * scale)
            torch.testing.assert_close(aux, aux_w, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(
                full[0], want + moe.shared_expert_ffn(cfg, p, x), rtol=1e-5,
                atol=1e-5 * float(full.abs().max()))


# (d, f, E, k, act): Qwen1.5-MoE-A2.7B's experts whole; DeepSeek-V3's
# router at a narrow width; widths that are no multiple of 4 or of the
# kernel's 32-column tiles (its scalar loads), with the other activations
MOE_SHAPES = {"qwen": (2048, 1408, 60, 4, "silu"),
              "deepseek-router": (256, 128, 256, 8, "silu"),
              "ragged-gelu": (130, 70, 5, 2, "gelu"),
              "ragged-relu": (97, 45, 6, 3, "relu")}


def _moe_inputs(dev, dtype, T, d, f, E, k, seed):
    """x, order, offsets, gates and the three stacked expert weights (std
    1/sqrt(fan-in)) of a random top-k routing of T tokens."""
    from repro_torch.models import moe
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, d), generator=gen, device=dev)
    ws = [torch.randn(s, generator=gen, device=dev) / s[1] ** 0.5
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    probs = torch.softmax(torch.randn((T, E), generator=gen, device=dev), -1)
    gates, idx = torch.topk(probs, k, dim=-1)
    order, offsets = moe._route(E, idx)
    return [x.to(dtype), order, offsets, gates, *(w.to(dtype) for w in ws)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("T", [1, 4, 16, 64])
@pytest.mark.parametrize("shape", list(MOE_SHAPES))
def test_moe_experts_match_plain(cuda, shape, T, dtype):
    """The grouped expert kernel against its plain version on the card
    (the per-expert products with ``torch.matmul``, TF32 off): fp32 at
    2e-5 of the output's scale, bf16 (fp32 sums in the kernel, bf16
    products in the plain version) at 2e-2. One wrapper call per call."""
    from repro_torch.kernels import moe_experts as tmx
    d, f, E, k, act = MOE_SHAPES[shape]
    args = _moe_inputs(cuda, dtype, T, d, f, E, k, seed=T)
    n0 = tmx.moe_experts.launches
    got = tmx.moe_experts(*args, act, k)
    assert tmx.moe_experts.launches == n0 + 1
    want = tmx.moe_experts_plain(*args, act, k)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (T * k, d)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)


def test_moe_layer_in_a_cuda_graph(cuda):
    """One MoE layer (router, routing, the grouped kernel, shared expert)
    captured in a CUDA graph, which refuses any host sync, and replayed
    after its input is rewritten in place: each replay equals eager
    execution bit for bit."""
    import dataclasses
    from repro_torch.kernels import moe_experts as tmx
    from repro_torch.models import moe
    base = get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(base, d_model=256, moe=dataclasses.replace(
        base.moe, d_expert=128, d_shared=256))
    p = moe.init_moe_params(torch.Generator(device=cuda).manual_seed(0),
                            cfg, torch.float32, cuda, 1)
    p = {k: (v[0] if torch.is_tensor(v) else
             {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    x = torch.randn((1, 4, 256), device=cuda)

    def run():
        with torch.inference_mode():
            return moe.moe_ffn(cfg, p, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # build, attributes, allocator
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = tmx.moe_experts.launches
    with torch.cuda.graph(graph):
        outs = run()
    assert tmx.moe_experts.launches == n0 + 1
    for seed in (1, 2):
        x.copy_(torch.randn(x.shape, generator=torch.Generator(
            device=cuda).manual_seed(seed), device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(outs, run()):
            assert torch.equal(a, b)


def test_mla_paged_matches_dense_on_card(cuda):
    """DeepSeek-V3's reduced MLA on the card: prefill 6 and a chunk of 2
    through a shuffled paged pool against the dense cache on the card
    (1e-5), and both against the CPU (5e-3: bf16 ckv/krope, as
    test_model_on_card_matches_cpu)."""
    cfg = get_config("deepseek-v3-671b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8))
    bt = [[6, 3], [2, 7]]
    outs = {}
    for dev, p in (("cpu", params), ("cuda", tree_to(params, cuda))):
        for paged in (False, True):
            cache = kvc.init_paged_pool(cfg, 8, 4, device=dev) if paged \
                else kvc.init_cache(cfg, 2, 16, device=dev)
            kw = {"block_tables": torch.tensor(bt, dtype=torch.int32,
                                               device=dev)} if paged else {}
            got = []
            with torch.inference_mode():
                for lo, hi in ((0, 6), (6, 8)):
                    x = torch.as_tensor(toks[:, lo:hi], device=dev)
                    logits, cache = apply_model(cfg, p, x, cache, lo, **kw)
                    got.append(logits.float().cpu())
            outs[(dev, paged)] = got
    for a, b in zip(outs[("cuda", True)], outs[("cuda", False)]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for paged in (False, True):
        for a, b in zip(outs[("cuda", paged)], outs[("cpu", paged)]):
            torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch,paged", [("qwen2-moe-a2.7b", False),
                                        ("qwen2-moe-a2.7b", True),
                                        ("hymba-1.5b", False)],
                         ids=["moe-dense", "moe-paged", "hybrid-dense"])
def test_reduced_engine_on_card_decodes_cpu_tokens(cuda, arch, paged):
    """The reduced MoE and hybrid engines on the card, holding the CPU
    engine's weights: the same greedy text for two prompts, 8 tokens
    each; the paged pool audits clean after release."""
    from repro_torch.engines.llm_engine import LLMEngine
    cfg = get_config(arch).reduced()
    kw = dict(max_len=128, max_batch=4, paged=paged, block_size=8)
    ref = LLMEngine("t", cfg, device="cpu", **kw)
    eng = LLMEngine("t", cfg, device=cuda, **kw)
    eng.params = tree_to(ref.params, cuda)
    tasks = [{"sid": "a", "text": "what is fact 3 about optics"},
             {"sid": "b", "text": "an unrelated prompt of some length"}]
    out = []
    for e in (ref, eng):
        e.op_prefill([dict(t) for t in tasks])
        out.append(e.op_decode([{"sid": "a", "max_new": 8},
                                {"sid": "b", "max_new": 8}]))
        for sid in ("a", "b"):
            e.release(sid)
    assert out[0] == out[1] and all(out[1])
    if paged:
        assert eng.alloc.audit()["ok"]
        assert eng.alloc.free_blocks() == eng.alloc.capacity


# ---------------------------------------------------------------------------
# K6's backward kernel and training on the card

def _k6_grads(fn, xs, dy, ds):
    """Gradients of sum(y dy) + sum(S ds) through ``fn`` (rwkv6_scan or
    rwkv6_scan_plain) with respect to all six inputs."""
    leaves = [x.clone().requires_grad_() for x in xs]
    y, st = fn(*leaves)
    return torch.autograd.grad((y * dy).sum() + (st * ds).sum(), leaves)


def _rel_err(got, want):
    return max((g.double() - w.double()).abs().max().item()
               / w.double().abs().max().item() for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 33, 128, 300])
def test_rwkv6_scan_bwd_matches_autograd_through_plain(cuda, dtype, hd, S):
    """rwkv6_scan under autograd (K6 saving its boundary states, then the
    backward kernel) against autograd through the plain recurrence on the
    same leaves: dr, dk, dv, dw, du and dstate0 within 1e-4 of each one's
    largest magnitude for fp32 inputs (summation order), 1e-2 for bf16
    inputs (bf16 gradients on both sides, which may round one bf16 step
    apart); one forward and one backward launch."""
    rs = np.random.RandomState(S * 5 + hd)
    xs = _scan_inputs(rs, 2, S, 3, hd, cuda, dtype)
    dy = _randn(rs, (2, S, 3, hd), cuda, torch.float32)
    ds = _randn(rs, (2, 3, hd, hd), cuda, torch.float32)
    n0 = (tscan.rwkv6_scan.launches, tscan.rwkv6_scan_bwd.launches)
    got = _k6_grads(tscan.rwkv6_scan, xs, dy, ds)
    torch.cuda.synchronize()
    assert (tscan.rwkv6_scan.launches - n0[0],
            tscan.rwkv6_scan_bwd.launches - n0[1]) == (1, 1)
    want = _k6_grads(tscan.rwkv6_scan_plain, xs, dy, ds)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert _rel_err(got, want) <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("B", [1, 2, 4])
def test_rwkv6_scan_bwd_at_full_heads(cuda, B):
    """RWKV-6 3B's heads (H = 40, hd = 64) at S = 512, fp32: the backward
    kernel's gradients against autograd through the plain recurrence within
    1e-4 of each one's largest magnitude, one launch each way."""
    rs = np.random.RandomState(B)
    xs = _scan_inputs(rs, B, 512, 40, 64, cuda, torch.float32)
    dy = _randn(rs, (B, 512, 40, 64), cuda, torch.float32)
    ds = _randn(rs, (B, 40, 64, 64), cuda, torch.float32)
    n0 = (tscan.rwkv6_scan.launches, tscan.rwkv6_scan_bwd.launches)
    got = _k6_grads(tscan.rwkv6_scan, xs, dy, ds)
    torch.cuda.synchronize()
    assert (tscan.rwkv6_scan.launches - n0[0],
            tscan.rwkv6_scan_bwd.launches - n0[1]) == (1, 1)
    assert _rel_err(got, _k6_grads(tscan.rwkv6_scan_plain, xs, dy, ds)) \
        <= 1e-4


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S", [15, 16, 33, 100])
def test_rwkv6_scan_bwd_matches_split_plain(cuda, hd, S):
    """The backward kernel against the mirror of its order of summation
    (rwkv6_scan_bwd_split_plain) on the same card, fp32, with and without
    the final state's gradient: within 1e-6 of each gradient's largest
    magnitude (the two differ in fused multiply-adds only)."""
    rs = np.random.RandomState(S + hd)
    xs = _scan_inputs(rs, 2, S, 3, hd, cuda, torch.float32)
    dy = _randn(rs, (2, S, 3, hd), cuda, torch.float32)
    ds = _randn(rs, (2, 3, hd, hd), cuda, torch.float32)
    _, _, bnd = tscan.rwkv6_scan_save(*xs)
    for dstate in (None, ds):
        got = tscan.rwkv6_scan_bwd(*xs[:5], bnd, dy, dstate)
        want = tscan.rwkv6_scan_bwd_split_plain(*xs[:5], bnd, dy, dstate)
        torch.cuda.synchronize()
        assert _rel_err(got, want) <= 1e-6


def test_rwkv6_scan_bwd_is_deterministic(cuda):
    """Two calls of the backward kernel on the same inputs are equal bit
    for bit (every sum in a fixed order, no atomics)."""
    rs = np.random.RandomState(77)
    xs = _scan_inputs(rs, 2, 100, 40, 64, cuda, torch.float32)
    dy = _randn(rs, (2, 100, 40, 64), cuda, torch.float32)
    ds = _randn(rs, (2, 40, 64, 64), cuda, torch.float32)
    _, _, bnd = tscan.rwkv6_scan_save(*xs)
    first = tscan.rwkv6_scan_bwd(*xs[:5], bnd, dy, ds)
    second = tscan.rwkv6_scan_bwd(*xs[:5], bnd, dy, ds)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", [5, 100])
def test_rwkv6_scan_bwd_against_float64(cuda, S):
    """The plain backward in float64 on the card (the kernels take fp32 or
    bf16 only) equals autograd through the float64 plain recurrence
    (gradcheck-style, 1e-10), and the kernel's fp32 gradients (from fp32
    inputs, the final state's gradient absent) are within 1e-5 of that
    float64 result, as K1 and K5 are held to float64."""
    rs = np.random.RandomState(S)
    xs = _scan_inputs(rs, 2, S, 2, 64, cuda, torch.float32)
    dy = _randn(rs, (2, S, 2, 64), cuda, torch.float32)
    x64 = [x.double() for x in xs]
    bnd = []
    tscan.rwkv6_scan_plain(*x64, boundaries=bnd)
    plain = tscan.rwkv6_scan_bwd_plain(*x64[:5], torch.stack(bnd),
                                       dy.double())
    leaves = [x.clone().requires_grad_() for x in x64]
    y, _ = tscan.rwkv6_scan_plain(*leaves)
    auto = torch.autograd.grad((y * dy.double()).sum(), leaves,
                               allow_unused=True)
    auto = [torch.zeros_like(x) if a is None else a
            for x, a in zip(x64, auto)]
    assert _rel_err(plain, auto) <= 1e-10
    _, _, bnd32 = tscan.rwkv6_scan_save(*xs)
    got = tscan.rwkv6_scan_bwd(*xs[:5], bnd32, dy)
    torch.cuda.synchronize()
    assert all(g.dtype == torch.float32 for g in got)
    assert _rel_err(got, auto) <= 1e-5


def test_rwkv6_scan_bwd_in_a_cuda_graph(cuda):
    """K6's training forward and its backward kernel captured in a CUDA
    graph, replayed after the inputs and dy are rewritten in place: each
    replay equals eager execution bit for bit."""
    rs = np.random.RandomState(140)
    xs = _scan_inputs(rs, 2, 70, 40, 64, cuda, torch.float32)
    dy = _randn(rs, (2, 70, 40, 64), cuda, torch.float32)
    ds = _randn(rs, (2, 40, 64, 64), cuda, torch.float32)

    def run():
        _, _, bnd = tscan.rwkv6_scan_save(*xs)
        return tscan.rwkv6_scan_bwd(*xs[:5], bnd, dy, ds)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # build, attributes, allocator
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for seed in (1, 2):
        new = _scan_inputs(np.random.RandomState(seed), 2, 70, 40, 64, cuda,
                           torch.float32)
        for a, b in zip(xs, new):
            a.copy_(b)
        dy.copy_(_randn(np.random.RandomState(seed), dy.shape, cuda,
                        torch.float32))
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(outs, run()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "tinyllama-1.1b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One train step of the reduced model (RWKV-6: K6 forward and
    backward per layer) on the card against the CPU on the same weights
    and tokens: loss and gnorm within 1e-4 relative, every gradient leaf
    within 1e-3 of its largest magnitude, the new params within 2 lr (Adam's
    first step is about lr * sign(g))."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training import train_step as ts
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 41)))
    oc = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    res = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = ts.next_token_loss(cfg, p, toks.to(dev),
                                     compute_dtype=torch.float32)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        n0 = tscan.rwkv6_scan_bwd.launches
        step = ts.make_train_step(cfg, oc, compute_dtype=torch.float32)
        _, _, m = step(p, init_opt_state(oc, p), {"tokens": toks.to(dev)})
        torch.cuda.synchronize()
        if arch == "rwkv6-3b":
            assert tscan.rwkv6_scan_bwd.launches - n0 == \
                (0 if dev == "cpu" else cfg.num_layers)
        res[str(dev)] = (float(loss.detach()), [g.cpu() for g in grads],
                         {k: float(v) for k, v in m.items()},
                         [t.cpu() for t in tree_leaves(p)])
    (l0, g0, m0, p0), (l1, g1, m1, p1) = res["cpu"], res[str(cuda)]
    assert l1 == pytest.approx(l0, rel=1e-4)
    assert _rel_err(g1, g0) <= 1e-3
    for k in ("loss", "gnorm"):
        assert m1[k] == pytest.approx(m0[k], rel=1e-4)
    assert max((a - b).abs().max().item() for a, b in zip(p1, p0)) <= \
        2 * oc.lr + 1e-5


@pytest.mark.parametrize("arch", ["rwkv6-3b", "tinyllama-1.1b"])
def test_bf16_train_step_on_card_matches_cpu(cuda, arch):
    """One train step of the reduced model at the reference's default
    compute dtype, bfloat16 (RWKV-6: K6 forward and backward in float32
    per layer, as the reference's scan step casts to float32), on the card
    against the CPU on the same weights and tokens: the loss within 1e-3
    relative, gnorm and every gradient leaf within 5e-2 of their largest
    magnitude (tests/test_torch_train_bf16.py states why), the new params
    within 2 lr."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training import train_step as ts
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 41)))
    oc = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    res = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        n0 = (tscan.rwkv6_scan.launches, tscan.rwkv6_scan_bwd.launches)
        loss, _ = ts.next_token_loss(cfg, p, toks.to(dev))
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        _, _, m = ts.make_train_step(cfg, oc)(p, init_opt_state(oc, p),
                                              {"tokens": toks.to(dev)})
        torch.cuda.synchronize()
        if arch == "rwkv6-3b":
            n = 0 if dev == "cpu" else 2 * cfg.num_layers
            assert (tscan.rwkv6_scan.launches - n0[0],
                    tscan.rwkv6_scan_bwd.launches - n0[1]) == (n, n)
        res[str(dev)] = (float(loss.detach()), [g.cpu() for g in grads],
                         {k: float(v) for k, v in m.items()},
                         [t.cpu() for t in tree_leaves(p)])
    (l0, g0, m0, p0), (l1, g1, m1, p1) = res["cpu"], res[str(cuda)]
    assert l1 == pytest.approx(l0, rel=1e-3)
    assert m1["loss"] == pytest.approx(m0["loss"], rel=1e-3)
    assert _rel_err(g1, g0) <= 5e-2
    assert m1["gnorm"] == pytest.approx(m0["gnorm"], rel=5e-2)
    assert max((a - b).abs().max().item() for a, b in zip(p1, p0)) <= \
        2 * oc.lr + 1e-5
