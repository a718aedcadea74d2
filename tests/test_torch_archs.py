"""Every configuration of the repo (conftest's ASSIGNED list) on the port
against the reference package, at each one's reduced size, on the same
weights (converted by repro_torch.bridge) and numpy-seeded inputs: the
port's init (shapes, dtypes, scales), the no-cache logits, chunked prefill
and decode on a dense cache, the paged MLA pool, the Mamba branch with its
state carried across chunks, and the greedy tokens of the reduced MoE, MLA
and hybrid engines (dense and, where the reference pages them, paged).

Tolerances: logits at 1e-4 (absolute and relative; tests/test_torch_
model.py's LOGIT_TOL): both sides compute in float32 and differ only in
summation order. Cached calls run on float32 caches on both sides, so the
same tolerance holds (the engines' bfloat16 caches are held by their
greedy tokens). Init scales: the sample std of every leaf within 10% of
the reference's draw (the smallest random leaf has 1024 elements, whose
sample std strays about 2% from the true one).

MoE routing is exact top-k on both sides. A near-tie between two experts'
probabilities could flip a choice between XLA's and PyTorch's float32
sums; every routing decision below is checked to have a gap far above
that, so the comparison holds by margin, not by luck of a seed."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import ASSIGNED  # noqa: E402
from repro.configs.base import get_config  # noqa: E402
from repro.engines.llm_engine import LLMEngine  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import apply_model as japply  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro.serving import kv_cache as jkvc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.engines.llm_engine import LLMEngine as TLLMEngine  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.transformer import apply_model as tapply  # noqa: E402
from repro_torch.models.transformer import init_params as tinit  # noqa: E402
from repro_torch.serving import kv_cache as tkvc  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STD_TOL = 0.10


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


@functools.lru_cache(maxsize=None)
def _model(arch, seed=0):
    """Both configs, the reference's params and the port's bridged copy,
    made once per arch and shared by the tests (which only read them)."""
    cfg, tcfg = get_config(arch).reduced(), tget_config(arch).reduced()
    jp = jinit(cfg, jax.random.key(seed))
    tp = bridge.decoder_params(_np_tree(jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _inputs(cfg, B, S, seed=1):
    """Tokens, or float embeddings for the stubbed-frontend configs."""
    rs = np.random.RandomState(seed)
    if cfg.embed_stub:
        return rs.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _f32_caches(cfg, tcfg, B, max_len):
    jc = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jkvc.init_cache(cfg, B, max_len))
    tc = {"stages": [[{k: v.float() for k, v in el.items()} for el in st]
                     for st in tkvc.init_cache(tcfg, B, max_len,
                                               device="cpu")["stages"]]}
    return jc, tc


def _min_router_gap(tcfg, tp, x):
    """The smallest probability gap between the k-th and (k+1)-th expert
    over every token of x (B,S,d) at every MoE layer's router, on the
    port's own hidden states: wraps moe.router_probs."""
    from repro_torch.models import moe
    gaps, orig = [], moe.router_probs

    def traced(cfg, w, x2d):
        probs = torch.softmax(x2d.float() @ w.float(), dim=-1)
        top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return orig(cfg, w, x2d)
    moe.router_probs = traced
    try:
        tapply(tcfg, tp, x)
    finally:
        moe.router_probs = orig
    return min(gaps) if gaps else float("inf")


# ---------------------------------------------------------------------------
# init

@pytest.mark.parametrize("arch", ASSIGNED)
def test_init_params_shapes_dtypes_scales_match_reference(arch):
    """The same tree, leaf shapes and dtypes, and every leaf's std within
    10% of the reference's draw (float32 params; the bfloat16 dtypes are
    held by test_bfloat16_params_keep_reference_fp32_leaves)."""
    cfg, tcfg, jp, _ = _model(arch)
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tp = tinit(tcfg, torch.Generator().manual_seed(0), torch.float32,
               "cpu")
    tl = jax.tree_util.tree_flatten_with_path(tp,
                                              is_leaf=torch.is_tensor)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        name = jax.tree_util.keystr(path)
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), name
        ja = np.asarray(a, np.float64)
        sj, st = float(ja.std()), float(b.double().std())
        mj = abs(float(ja.mean())) + 1.0
        if sj <= 1e-5 * mj:             # a constant leaf (zeros, -4.6, ...)
            assert st <= 1e-5 * mj and float(b.double().mean()) == \
                pytest.approx(float(ja.mean()), rel=1e-5, abs=1e-6), name
        else:
            assert abs(st / sj - 1.0) < STD_TOL, (name, st, sj)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b",
                                  "rwkv6-3b"])
def test_bfloat16_params_keep_reference_fp32_leaves(arch):
    """The reference's bfloat16 init keeps the router, dt_bias, A_log, D,
    w_base, u and gn_scale in float32. The port's bfloat16 init has the
    same dtypes, and so has a float32 reference tree bridged with
    dtype=bfloat16."""
    cfg, tcfg, jp, _ = _model(arch)
    want = [str(a.dtype) for a in jax.tree.leaves(jax.eval_shape(
        lambda k: jinit(cfg, k, jnp.bfloat16), jax.random.key(0)))]
    bridged = bridge.decoder_params(_np_tree(jp), tcfg, "cpu",
                                    dtype=torch.bfloat16)
    own = tinit(tcfg, torch.Generator().manual_seed(0), torch.bfloat16,
                "cpu")
    for tree in (bridged, own):
        got = [str(t.dtype).removeprefix("torch.")
               for t in jax.tree.leaves(tree, is_leaf=torch.is_tensor)]
        assert got == want
    assert "float32" in want and "bfloat16" in want


def test_dense_init_scales_in_place(monkeypatch):
    """dense_init returns the very tensor torch.randn drew when device and
    dtype match (scaled in place: a stacked expert tensor is never held
    twice), with the std 1/sqrt(fan_in)."""
    from repro_torch.models import common
    drawn = []
    orig = torch.randn

    def randn(*a, **kw):
        drawn.append(orig(*a, **kw))
        return drawn[-1]
    monkeypatch.setattr(torch, "randn", randn)
    w = common.dense_init(torch.Generator().manual_seed(0), (3, 60, 64),
                          torch.float32, "cpu", fan_in=60)
    assert w.data_ptr() == drawn[-1].data_ptr()
    assert abs(float(w.std()) * 60 ** 0.5 - 1.0) < 0.05
    e = common.embed_init(torch.Generator().manual_seed(0), (64, 32),
                          torch.float32, "cpu")
    assert e.data_ptr() == drawn[-1].data_ptr()


# ---------------------------------------------------------------------------
# model

@pytest.mark.parametrize("arch", ASSIGNED)
def test_no_cache_logits_match(arch):
    cfg, tcfg, jp, tp = _model(arch)
    x = _inputs(cfg, 2, 16)
    jl, _, _ = japply(cfg, jp, jnp.asarray(x))
    tl, cache = tapply(tcfg, tp, torch.from_numpy(x))
    assert cache is None
    if cfg.moe is not None:
        assert _min_router_gap(tcfg, tp, torch.from_numpy(x)) > 1e-4
    _close(tl, jl, **LOGIT_TOL)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_chunked_prefill_and_decode_on_dense_cache_match(arch):
    """6 + 5 + 1 tokens through a dense cache (as tests/
    test_cache_equivalence.py runs the reference): every call's logits
    and, at the end, every cache leaf (K/V, ckv/krope, the Mamba and RWKV
    states) equal the reference's."""
    cfg, tcfg, jp, tp = _model(arch)
    x = _inputs(cfg, 2, 16)
    jc, tc = _f32_caches(cfg, tcfg, 2, 32)
    for lo, hi in ((0, 6), (6, 11), (11, 12)):
        jl, jc, _ = japply(cfg, jp, jnp.asarray(x[:, lo:hi]), jc, lo)
        tl, tc = tapply(tcfg, tp, torch.from_numpy(x[:, lo:hi]), tc, lo)
        _close(tl, jl, **LOGIT_TOL)
    for a, b in zip(jax.tree.leaves(jc),
                    jax.tree.leaves(tc, is_leaf=torch.is_tensor)):
        _close(b, a, **LOGIT_TOL)


@pytest.mark.parametrize("bt", [[[1, 2], [3, 4]], [[6, 3], [2, 7]]],
                         ids=["ordered", "shuffled"])
def test_paged_mla_matches_dense_mla(bt):
    """DeepSeek-V3's MLA on the paged pool (bfloat16 ckv/krope written
    through the block tables, then gathered): the same logits as the
    dense cache on the port (1e-5, as tests/test_paged_kv.py holds the
    reference), and as the reference's paged pool, for a prefill of 6 and
    a chunk of 2."""
    cfg, tcfg, jp, tp = _model("deepseek-v3-671b")
    assert tcfg.attention_kind == "mla"
    x = _inputs(cfg, 2, 8)
    tbt = torch.tensor(bt, dtype=torch.int32)
    tc = tkvc.init_cache(tcfg, 2, 16, device="cpu")
    pool = tkvc.init_paged_pool(tcfg, 8, 4, device="cpu")
    assert set(pool["stages"][0][0]) == {"ckv", "krope"}
    jpool = jkvc.init_paged_pool(cfg, 8, 4)
    for lo, hi in ((0, 6), (6, 8)):
        xs = torch.from_numpy(x[:, lo:hi])
        ld, tc = tapply(tcfg, tp, xs, tc, lo)
        lp, pool = tapply(tcfg, tp, xs, pool, lo, block_tables=tbt)
        jl, jpool, _ = japply(cfg, jp, jnp.asarray(x[:, lo:hi]), jpool, lo,
                              block_tables=jnp.asarray(bt, jnp.int32))
        _close(lp[:, -1], ld[:, -1].numpy(), rtol=1e-5, atol=1e-5)
        _close(lp, jl, **LOGIT_TOL)


def test_mamba_branch_state_carried_across_chunks_matches():
    """Hymba's Mamba branch alone: one 12-token call, and 5 + 7 tokens
    with (h, conv) carried between them, both equal to the reference's on
    the same weights and states (outputs and both states), and the two
    splits equal to each other."""
    cfg, tcfg, jp, tp = _model("hymba-1.5b")
    jm = jax.tree.map(lambda a: a[0], jp["stages"][0][0]["mamba"])
    tm = {k: v[0] for k, v in tp["stages"][0][0]["mamba"].items()}
    rs = np.random.RandomState(3)
    B, d, s = 2, cfg.d_model, cfg.ssm
    x = rs.standard_normal((B, 12, d)).astype(np.float32)
    h0 = rs.standard_normal((B, d, s.state_dim)).astype(np.float32) * 0.1
    c0 = rs.standard_normal((B, s.conv_dim - 1, d)).astype(np.float32)
    outs = {}
    for split in ((0, 12), (0, 5, 12)):
        jh, jcv = jnp.asarray(h0), jnp.asarray(c0)
        th, tcv = torch.from_numpy(h0), torch.from_numpy(c0)
        jo, to = [], []
        for lo, hi in zip(split, split[1:]):
            o, jh, jcv = jssm.mamba_branch(cfg, jm, jnp.asarray(x[:, lo:hi]),
                                           jh, jcv)
            jo.append(np.asarray(o))
            o, th, tcv = tssm.mamba_branch(tcfg, tm,
                                           torch.from_numpy(x[:, lo:hi]),
                                           th, tcv)
            to.append(o)
        _close(torch.cat(to, 1), np.concatenate(jo, 1), **LOGIT_TOL)
        _close(th, jh, **LOGIT_TOL)
        _close(tcv, jcv, **LOGIT_TOL)
        outs[len(split)] = (torch.cat(to, 1), th, tcv)
    for a, b in zip(outs[2], outs[3]):
        _close(a, b.numpy(), **LOGIT_TOL)


def test_paged_pool_refuses_recurrent_layers():
    """Paging a recurrent layer stays refused, as in the reference."""
    for arch in ("hymba-1.5b", "rwkv6-3b"):
        with pytest.raises(ValueError, match="rwkv|hybrid"):
            tkvc.init_paged_pool(tget_config(arch), 8, 16, device="cpu")
        with pytest.raises(ValueError, match="rwkv|hybrid"):
            TLLMEngine("t", tget_config(arch).reduced(), paged=True,
                       device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b",
                                  "hymba-1.5b"])
def test_cache_bytes_match_reference(arch):
    cfg, tcfg = get_config(arch), tget_config(arch)
    assert tkvc.cache_bytes(tcfg, 2, 512) == jkvc.cache_bytes(cfg, 2, 512)
    assert tkvc.bytes_per_token(tcfg) == jkvc.bytes_per_token(cfg)
    if arch != "hymba-1.5b":
        assert tkvc.paged_block_bytes(tcfg, 16) == \
            jkvc.paged_block_bytes(cfg, 16)


# ---------------------------------------------------------------------------
# engines

ENGINE_CASES = [("qwen2-moe-a2.7b", False), ("qwen2-moe-a2.7b", True),
                ("deepseek-v3-671b", False), ("deepseek-v3-671b", True),
                ("hymba-1.5b", False)]


@pytest.mark.parametrize("arch,paged", ENGINE_CASES,
                         ids=[f"{a}-{'paged' if p else 'dense'}"
                              for a, p in ENGINE_CASES])
def test_engine_greedy_tokens_match_reference(arch, paged):
    """The reduced engine on both packages, the reference engine's seed-0
    weights bridged into the port: op_prefill of two prompts then
    op_decode of 8 tokens each, the same greedy text."""
    cfg, tcfg = get_config(arch).reduced(), tget_config(arch).reduced()
    kw = dict(max_len=128, max_batch=4, paged=paged, block_size=8)
    ref = LLMEngine("t", cfg, seed=0, **kw)
    port = TLLMEngine("t", tcfg, device="cpu", **kw)
    port.params = bridge.decoder_params(_np_tree(ref.params), tcfg, "cpu")
    tasks = [{"sid": "a", "text": "what is fact 3 about optics"},
             {"sid": "b", "text": "an unrelated prompt of some length"}]
    out = []
    for eng in (ref, port):
        eng.op_prefill([dict(t) for t in tasks])
        out.append(eng.op_decode([{"sid": "a", "max_new": 8},
                                  {"sid": "b", "max_new": 8}]))
        for sid in ("a", "b"):
            eng.release(sid)
        if paged:
            assert eng.alloc.free_blocks() == eng.alloc.capacity
    assert out[0] == out[1]
    assert all(out[1])
