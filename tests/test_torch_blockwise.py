"""The port's query blocks (models/attention.py: ``blockwise_over_q``,
``gqa_attention``, ``_gqa_causal_skip``, MLA's blocked core), the train
step at q_block = 64, the LSE outputs of K1's and K2's plain versions,
and the writes into a rank's slice of a sequence-split cache, against the
reference on the same numpy-seeded inputs.

Tolerances: attention outputs at 2e-5 absolute (float32, unit-scale
inputs), their gradients at 1e-5 of each gradient's largest magnitude;
the train step at test_torch_train.py's (loss, ce and gnorm 1e-5
relative, params by its sign-flip rule); the LSEs against a float64
log-sum-exp of the masked scores at 1e-5 absolute, a row that sees no key
exactly o = 0 and lse = -inf."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402,E501
from repro_torch.kernels.flash_prefill import flash_prefill  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serving.kv_cache import write_linear, write_ring  # noqa: E402,E501
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

OUT_TOL = 2e-5
GRAD_TOL = 1e-5
LSE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads_close(tg, jg):
    for t, j in zip(tg, jg):
        j = np.asarray(j)
        err = float(np.abs(t.detach().numpy() - j).max())
        assert err <= GRAD_TOL * float(np.abs(j).max()), (err,)


@pytest.mark.parametrize("window,cap,causal_skip", [
    (None, None, False), (48, None, False), (None, 30.0, False),
    (None, None, True), (48, None, True)])
def test_gqa_attention_blocks_match_reference(window, cap, causal_skip):
    """128 queries in blocks of 32 (the blocks above the diagonal skipped
    under causal_skip), against the reference's ``gqa_attention``: the
    output and the gradients of q, k and v."""
    rs = np.random.RandomState(0)
    B, S, H, K, hd = 2, 128, 4, 2, 16
    q, k, v = (rs.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (H, K, K))
    cot = rs.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    kw = dict(scale=hd ** -0.5, window=window, cap=cap, q_block=32,
              causal_skip=causal_skip)

    def jloss(q, k, v):
        o = jattn.gqa_attention(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                                **kw)
        return jnp.sum(o * cot), o
    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    to = tattn.gqa_attention(tq, tk, tv, torch.from_numpy(pos.copy()),
                             torch.from_numpy(pos.copy()), **kw)
    (to * torch.from_numpy(cot)).sum().backward()
    assert float(np.abs(to.detach().numpy() - np.asarray(jo)).max()) \
        <= OUT_TOL
    _grads_close((tq.grad, tk.grad, tv.grad), jg)


@pytest.mark.parametrize("window", [None, 48])
def test_mla_layer_blocks_match_reference(window):
    """DeepSeek-V3's MLA layer (reduced) without a cache over 128 queries
    in blocks of 32, against the reference's ``mla_layer``: the output and
    the gradient of the layer's input."""
    cfg, tcfg = (get_config("deepseek-v3-671b").reduced(),
                 tget_config("deepseek-v3-671b").reduced())
    spec = cfg.stages[0].pattern[0].__class__(kind="attn", window=window)
    jp = jinit(cfg, jax.random.key(0))
    tp = bridge.decoder_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jl = jax.tree.map(lambda a: a[0], jp["stages"][0][0]["attn"])
    tl = tree_map(lambda a: a[0], tp["stages"][0][0]["attn"])
    rs = np.random.RandomState(1)
    x = rs.standard_normal((2, 128, cfg.d_model)).astype(np.float32)
    cot = rs.standard_normal(x.shape).astype(np.float32)

    def jloss(x):
        o, _ = jattn.mla_layer(cfg, spec, jl, x, None, 0, q_block=32)
        return jnp.sum(o * cot), o
    (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(x)
    tx = torch.from_numpy(x).requires_grad_(True)
    to, _ = tattn.mla_layer(tcfg, spec, tl, tx, None, 0, q_block=32)
    (to * torch.from_numpy(cot)).sum().backward()
    err = float(np.abs(to.detach().numpy() - np.asarray(jo)).max())
    assert err <= OUT_TOL * max(1.0, float(np.abs(jo).max())), err
    _grads_close((tx.grad,), (jg,))


def test_train_step_q_block_64_matches_reference():
    """The reduced TinyLlama train step at 2 x 256 tokens in query blocks
    of 64, against the reference's ``make_train_step(q_block=64)``."""
    cfg, tcfg = (get_config("tinyllama-1.1b").reduced(),
                 tget_config("tinyllama-1.1b").reduced())
    jp = jinit(cfg, jax.random.key(0))
    tp = bridge.decoder_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 257)).astype(np.int32)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jts.make_train_step(
        cfg, jopt.AdamWConfig(**kw), compute_dtype=jnp.float32, q_block=64))
    jp2, _, jm = jstep(jp, jopt.init_opt_state(jopt.AdamWConfig(**kw), jp),
                       {"tokens": jnp.asarray(toks)})
    tstep = tts.make_train_step(tcfg, topt.AdamWConfig(**kw),
                                compute_dtype=torch.float32, q_block=64)
    tp2, _, tm = tstep(tp, topt.init_opt_state(topt.AdamWConfig(**kw), tp),
                       {"tokens": torch.from_numpy(toks)})
    for k in ("loss", "ce", "gnorm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    grad = jax.grad(lambda p: jts.next_token_loss(
        cfg, p, jnp.asarray(toks), compute_dtype=jnp.float32,
        q_block=64)[0])(jp)
    for (path, t), j, g in zip(
            jax.tree_util.tree_flatten_with_path(
                tp2, is_leaf=torch.is_tensor)[0],
            jax.tree.leaves(jp2), jax.tree.leaves(grad)):
        t, j, g = t.numpy(), np.asarray(j), np.abs(np.asarray(g))
        firm = g >= 1e-4 * g.max()
        np.testing.assert_allclose(t[firm], j[firm], rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
        assert np.all(np.abs(t - j) <= 2 * kw["lr"] + 1e-5)


def _saved_bytes(q_block):
    """Bytes autograd saves in one reduced TinyLlama-shaped GQA layer's
    no-cache forward over 1024 tokens."""
    cfg = tget_config("tinyllama-1.1b").reduced()
    spec = cfg.stages[0].pattern[0]
    p = {k: v[0] for k, v in tattn.init_gqa_params(
        torch.Generator().manual_seed(0), cfg, torch.float32, "cpu",
        1).items()}
    x = torch.randn((1, 1024, cfg.d_model), requires_grad=True)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, _ = tattn.gqa_layer(cfg, spec, p, x, None, 0, q_block=q_block)
    out.sum().backward()
    return sum(saved)


def test_blocked_forward_saves_under_a_quarter():
    """The scores of every block are recomputed in the backward, so the
    blocked forward keeps under a quarter of the unblocked one's bytes
    (there the (B, K, G, S, S) scores and probabilities dominate)."""
    whole, blocked = _saved_bytes(1024), _saved_bytes(64)
    assert blocked < whole / 4, (blocked, whole)


def _lse64(s, mask):
    """float64 log-sum-exp over the last axis of the masked scores, -inf
    where no key is visible."""
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.log(np.exp(s - np.where(np.isfinite(m), m, 0)).sum(-1)) + \
            np.where(np.isfinite(m), m, 0)[..., 0]
    return np.where(mask.any(-1), out, -np.inf)


@pytest.mark.parametrize("prefix,cap,window", [
    ([-40, -5, 0, 30], None, None), ([-5, 3, 70, 200], 20.0, None),
    ([-5, 3, 12, 100], None, 8)])
def test_flash_prefill_lse_plain(prefix, cap, window):
    """K1's plain version with ``return_lse`` on a rank's slice: local
    prefixes below 0 (rows before the slice see no key) and past T."""
    rs = np.random.RandomState(2)
    B, Sq, H, K, hd, T = 4, 16, 4, 2, 16, 64
    q = rs.standard_normal((B, Sq, H, hd))
    k, v = (rs.standard_normal((B, T, K, hd)) for _ in range(2))
    o, lse = flash_prefill(torch.from_numpy(q).float(),
                           torch.from_numpy(k).float(),
                           torch.from_numpy(v).float(),
                           prefix_len=torch.tensor(prefix), cap=cap,
                           window=window, return_lse=True)
    G = H // K
    s = np.einsum("bskgh,btkh->bskgt", q.reshape(B, Sq, K, G, hd), k) * \
        hd ** -0.5
    if cap is not None:
        s = cap * np.tanh(s / cap)
    qp = np.asarray(prefix)[:, None] + np.arange(Sq)
    kp = np.arange(T)
    mask = (kp[None, None] <= qp[..., None]) & (kp < T)
    if window is not None:
        mask &= kp[None, None] > qp[..., None] - window
    want = _lse64(s, mask[:, :, None, None]).reshape(B, Sq, H)
    empty = ~mask.any(-1)
    assert empty.any() and (~empty).any()
    got = lse.numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= LSE_TOL
    assert not torch.isnan(o).any()
    assert (o[torch.from_numpy(np.repeat(empty[..., None], H, -1))] ==
            0).all()


def test_decode_attention_lse_plain():
    """K2's plain version with ``return_lse``: lengths 0 (a slice that
    holds none of the sequence) to T, with a softcap."""
    rs = np.random.RandomState(3)
    B, H, K, hd, T = 4, 8, 2, 16, 64
    q = rs.standard_normal((B, H, hd))
    k, v = (rs.standard_normal((B, T, K, hd)) for _ in range(2))
    length = np.array([0, 1, 33, 64])
    o, lse = decode_attention(torch.from_numpy(q).float(),
                              torch.from_numpy(k).float(),
                              torch.from_numpy(v).float(),
                              torch.from_numpy(length), cap=20.0,
                              return_lse=True)
    s = np.einsum("bkgh,btkh->bkgt", q.reshape(B, K, H // K, hd), k) * \
        hd ** -0.5
    s = 20.0 * np.tanh(s / 20.0)
    mask = np.arange(T)[None] < length[:, None]
    want = _lse64(s, mask[:, None, None]).reshape(B, H)
    got = lse.numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[0]).all() and np.isfinite(got[1:]).all()
    assert np.abs(got[1:] - want[1:]).max() <= LSE_TOL
    assert (o[0] == 0).all() and not torch.isnan(o).any()


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("pos", [0, 13, 29, [30, 2, 17]])
def test_slice_writes_tile_the_whole_write(ring, pos):
    """Each of 4 slices of a 32-slot cache written with ``seq=(first,
    32)`` equals that slice of the whole cache's write: the linear write
    clamped to 32 - S on the whole cache first, the ring wrapped."""
    buf = torch.arange(3 * 32 * 2, dtype=torch.float32).reshape(3, 32, 2)
    chunk = -torch.arange(1, 3 * 7 * 2 + 1,
                          dtype=torch.float32).reshape(3, 7, 2)
    write = write_ring if ring else write_linear
    p = torch.tensor(pos) if isinstance(pos, list) else pos
    whole = write(buf.clone(), chunk, p)
    for i in range(4):
        part = write(buf[:, 8 * i:8 * i + 8].clone(), chunk, p,
                     seq=(8 * i, 32))
        assert torch.equal(part, whole[:, 8 * i:8 * i + 8]), i
