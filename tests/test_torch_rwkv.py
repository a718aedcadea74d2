"""The port's RWKV-6 path against the reference on the same weights and
numpy-seeded inputs: the plain version of the WKV scan (K6) against the
reference's oracle and its Pallas kernel in interpret mode, the time and
channel mixes, the model with and without its dense recurrent cache, and
the dense LLMEngine's greedy tokens, including the reference faults that
the port reproduces on purpose (ROADMAP.md Queue 3). Naive-RAG end to end
with the RWKV core LLM: tests/test_torch_rwkv_e2e.py. The CUDA kernel
against the plain version: tests/test_torch_cuda.py.

Tolerances: the scan at 2e-4 (tests/test_kernels.py's), the mixes and
every cache leaf at 1e-4, logits at 1e-4 (tests/test_torch_model.py's
LOGIT_TOL): both sides compute in float32 and differ only in summation
order."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import Stage, get_config  # noqa: E402
from repro.engines.llm_engine import LLMEngine  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import apply_model as japply  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro.serving import kv_cache as jkvc  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import Stage as TStage  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.engines.llm_engine import LLMEngine as TLLMEngine  # noqa: E402
from repro_torch.kernels import rwkv6_scan as tscan  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.transformer import apply_model as tapply  # noqa: E402
from repro_torch.models.transformer import init_params as tinit  # noqa: E402
from repro_torch.serving import kv_cache as tkvc  # noqa: E402

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NAME = "rwkv6-3b"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _cfgs():
    return get_config(NAME).reduced(), tget_config(NAME).reduced()


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params)."""
    cfg, tcfg = _cfgs()
    jp = jinit(cfg, jax.random.key(0))
    return cfg, tcfg, jp, bridge.decoder_params(_np_tree(jp), tcfg, "cpu")


# ---------------------------------------------------------------------------
# K6: the WKV scan's plain version

def _scan_inputs(seed, B, S, H, hd, zero_u=False):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rs = np.random.RandomState(seed)
    r, k, v = [rs.standard_normal((B, S, H, hd)).astype(np.float32) * 0.5
               for _ in range(3)]
    w = (1 / (1 + np.exp(-rs.standard_normal((B, S, H, hd)))) * 0.5
         + 0.4).astype(np.float32)
    u = np.zeros((H, hd), np.float32) if zero_u else \
        rs.standard_normal((H, hd)).astype(np.float32) * 0.1
    s0 = rs.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,S,H,hd,chunk,dtype", [
    (1, 64, 2, 32, 16, "float32"), (2, 128, 4, 64, 64, "float32"),
    (1, 96, 3, 64, 32, "float32"),
    (2, 1, 4, 64, 64, "float32"),              # one decode step
    (2, 48, 2, 32, 16, "bfloat16"),            # bf16 r, k, v, w
])
def test_scan_plain_matches_reference_and_pallas(B, S, H, hd, chunk, dtype):
    xs = _scan_inputs(B * 100 + S, B, S, H, hd)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx = [jnp.asarray(a, jdt) for a in xs[:4]] + \
        [jnp.asarray(a) for a in xs[4:]]
    tx = [torch.from_numpy(a).to(tdt) for a in xs[:4]] + \
        [torch.from_numpy(a) for a in xs[4:]]
    y_ref, s_ref = ref.rwkv6_scan_ref(*jx)
    y_pl, s_pl = ops.rwkv6_scan(*jx, chunk=chunk, interpret=True)
    y, st = tscan.rwkv6_scan(*tx)
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, H, hd)
    assert tscan.rwkv6_scan.launches == 0       # CPU: the plain version
    for got, want in ((y, y_ref), (y, y_pl), (st, s_ref), (st, s_pl)):
        _close(got, want, **SCAN_TOL)


@pytest.mark.parametrize("B,S,H,hd,chunk,dtype", [
    (1, 64, 2, 32, 16, "float32"), (2, 128, 4, 64, 64, "float32"),
    (1, 96, 3, 64, 32, "float32"),
    (2, 1, 4, 64, 64, "float32"),              # one decode step
    (2, 48, 2, 32, 16, "bfloat16"),            # bf16 r, k, v, w
])
def test_scan_split_plain_matches_reference_and_pallas(B, S, H, hd, chunk,
                                                       dtype):
    """The CUDA kernel's order of summation (8 row-group partials per
    column, the bonus term once per step), mirrored on the CPU, against
    the reference's oracle and its Pallas kernel at 1e-4."""
    xs = _scan_inputs(B * 100 + S + 1, B, S, H, hd)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx = [jnp.asarray(a, jdt) for a in xs[:4]] + \
        [jnp.asarray(a) for a in xs[4:]]
    tx = [torch.from_numpy(a).to(tdt) for a in xs[:4]] + \
        [torch.from_numpy(a) for a in xs[4:]]
    y_ref, s_ref = ref.rwkv6_scan_ref(*jx)
    y_pl, s_pl = ops.rwkv6_scan(*jx, chunk=chunk, interpret=True)
    y, st = tscan.rwkv6_scan_split_plain(*tx)
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, H, hd)
    for got, want in ((y, y_ref), (y, y_pl), (st, s_ref), (st, s_pl)):
        _close(got, want, rtol=1e-4, atol=1e-4)


def test_scan_state_carry():
    """Two halves with the state carried == one scan (the property the
    engine's partial prefill relies on), on both packages."""
    r, k, v, w, u, s0 = map(torch.from_numpy,
                            _scan_inputs(6, 1, 128, 2, 32, zero_u=True))
    s0 = torch.zeros_like(s0)
    y_full, s_full = tscan.rwkv6_scan(r, k, v, w, u, s0)
    y1, s1 = tscan.rwkv6_scan(r[:, :64], k[:, :64], v[:, :64], w[:, :64], u,
                              s0)
    y2, s2 = tscan.rwkv6_scan(r[:, 64:], k[:, 64:], v[:, 64:], w[:, 64:], u,
                              s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(s2, s_full, rtol=1e-5, atol=1e-5)
    jx = [jnp.asarray(a.numpy()) for a in (r, k, v, w, u, s0)]
    _, js1 = ops.rwkv6_scan(*[a[:, :64] for a in jx[:4]], jx[4], jx[5],
                            chunk=32, interpret=True)
    _close(s1, js1, **SCAN_TOL)


def test_scan_writes_out_state_in_place():
    xs = [torch.from_numpy(a) for a in _scan_inputs(7, 2, 5, 2, 32)]
    want_y, want_s = tscan.rwkv6_scan_plain(*xs)
    state = xs[5].clone()
    y, st = tscan.rwkv6_scan(*xs[:5], state, out_state=state)
    assert st is state
    torch.testing.assert_close(st, want_s, rtol=0, atol=0)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the mixes and the group norm

def test_group_norm_heads_matches():
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 5, 8, 32)).astype(np.float32) * 3 + 1
    s = rs.standard_normal((8, 32)).astype(np.float32)
    _close(tcommon.group_norm_heads(torch.from_numpy(x), torch.from_numpy(s),
                                    eps=64e-5),
           jcommon.group_norm_heads(jnp.asarray(x), jnp.asarray(s),
                                    eps=64e-5), **TOL)


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def test_time_mix_matches(model):
    cfg, tcfg, jp, tp = model
    jl = _layer(jp["stages"][0][0]["tm"])
    tl = {k: v[0] for k, v in tp["stages"][0][0]["tm"].items()}
    # nonzero u and a data-dependent state, so every term is exercised
    u = np.random.RandomState(1).standard_normal(jl["u"].shape).astype(
        np.float32) * 0.1
    jl["u"], tl["u"] = jnp.asarray(u), torch.from_numpy(u)
    rs = np.random.RandomState(2)
    d, H, hd = cfg.d_model, cfg.d_model // 32, 32
    x = rs.standard_normal((2, 7, d)).astype(np.float32)
    st = rs.standard_normal((2, H, hd, hd)).astype(np.float32) * 0.1
    sx = rs.standard_normal((2, d)).astype(np.float32)
    jo, js, jsx = jssm.rwkv_time_mix(cfg, jl, *map(jnp.asarray, (x, st, sx)))
    to, ts, tsx = tssm.rwkv_time_mix(tcfg, tl,
                                     *map(torch.from_numpy, (x, st, sx)))
    for got, want in ((to, jo), (ts, js), (tsx, jsx)):
        _close(got, want, **TOL)


def test_channel_mix_matches(model):
    cfg, tcfg, jp, tp = model
    jl = _layer(jp["stages"][0][0]["cm"], 1)
    tl = {k: v[1] for k, v in tp["stages"][0][0]["cm"].items()}
    rs = np.random.RandomState(3)
    x = rs.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    sx = rs.standard_normal((2, cfg.d_model)).astype(np.float32)
    jo, jsx = jssm.rwkv_channel_mix(cfg, jl, jnp.asarray(x), jnp.asarray(sx))
    to, tsx = tssm.rwkv_channel_mix(tcfg, tl, torch.from_numpy(x),
                                    torch.from_numpy(sx))
    _close(to, jo, **TOL)
    _close(tsx, jsx, **TOL)


# ---------------------------------------------------------------------------
# model: init, bridge, apply, cache

@pytest.mark.parametrize("reduced", [True, False])
def test_init_shapes_and_scales_match_reference(reduced):
    """Same tree and shapes as the reference (the full config abstractly);
    the stacked LoRA weights take the fan-in of the unstacked tensor."""
    cfg, tcfg = get_config(NAME), tget_config(NAME)
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    else:       # full width, 1 layer (the layer tree is the same for 32)
        cfg = dataclasses.replace(cfg, stages=(
            Stage(cfg.stages[0].pattern, 1),))
        tcfg = dataclasses.replace(tcfg, stages=(
            TStage(tcfg.stages[0].pattern, 1),))
    jshapes = jax.eval_shape(lambda k: jinit(cfg, k), jax.random.key(0))
    tp = tinit(tcfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    jl = jax.tree.leaves(jshapes)
    tl = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tp,
                                      is_leaf=torch.is_tensor))
    assert [a.shape for a in jl] == [b.shape for b in tl]
    tm = tp["stages"][0][0]["tm"]
    L = tcfg.ssm.lora_rank
    assert abs(float(tm["mix_w2"].std()) * 5 ** 0.5 / 0.1 - 1) < 0.1
    assert abs(float(tm["w_w2"].std()) * L ** 0.5 / 0.1 - 1) < 0.1
    assert abs(float(tm["wr"].std()) * tcfg.d_model ** 0.5 - 1) < 0.05
    assert float(tm["u"].abs().max()) == 0.0
    assert bool((tm["w_base"] == -4.0).all())
    assert bool((tm["gn_scale"] == 1.0).all())


def test_bridge_takes_the_rwkv_tree(model):
    cfg, tcfg, jp, tp = model
    tree = _np_tree(jp)
    assert tp["stages"][0][0]["tm"]["mix_w2"].shape[0] == 2
    tree["stages"][0][0]["tm"]["u"] = tree["stages"][0][0]["tm"]["u"][0]
    with pytest.raises(ValueError, match="repeat axis"):
        bridge.decoder_params(tree, tcfg, "cpu")


def test_train_call_logits_match(model):
    cfg, tcfg, jp, tp = model
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 40))
    jl, _, _ = japply(cfg, jp, jnp.asarray(toks))
    tl, cache = tapply(tcfg, tp, torch.from_numpy(toks))
    assert cache is None
    _close(tl, jl, **LOGIT_TOL)


def test_prefill_and_decode_with_cache_match(model):
    """Prefill 16 tokens, then 4 decode steps, on a dense cache: logits
    and every cache leaf after every call."""
    cfg, tcfg, jp, tp = model
    B, max_len = 2, 64
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (B, 20))
    jc = jkvc.init_cache(cfg, B, max_len)
    tc = tkvc.init_cache(tcfg, B, max_len, device="cpu")
    leaves = tc["stages"][0][0]
    for lo, hi in [(0, 16)] + [(16 + i, 17 + i) for i in range(4)]:
        jl, jc, _ = japply(cfg, jp, jnp.asarray(toks[:, lo:hi]), jc, lo)
        tl, tc = tapply(tcfg, tp, torch.from_numpy(toks[:, lo:hi]), tc, lo)
        _close(tl, jl, **LOGIT_TOL)
        for key in ("state", "sx_tm", "sx_cm"):
            _close(tc["stages"][0][0][key], jc["stages"][0][0][key], **TOL)
        # written in place into the same buffers
        assert tc["stages"][0][0] is leaves


def test_cache_shapes_and_bytes_match():
    cfg, tcfg = get_config(NAME), tget_config(NAME)
    for c, tc in ((cfg, tcfg), (cfg.reduced(), tcfg.reduced())):
        shapes = jkvc.elem_cache_shape(c, c.stages[0].pattern[0], 2, 3, 512)
        tshapes = tkvc.elem_cache_shape(tc, tc.stages[0].pattern[0], 2, 3,
                                        512)
        assert {k: s for k, (s, _) in shapes.items()} == \
            {k: s for k, (s, _) in tshapes.items()}
        assert all(dt == torch.float32 for _, dt in tshapes.values())
        assert tkvc.cache_bytes(tc, 2, 512) == jkvc.cache_bytes(c, 2, 512)
        assert tkvc.bytes_per_token(tc) == jkvc.bytes_per_token(c)


# ---------------------------------------------------------------------------
# engine

def _engine_pair(model, max_len=128):
    """Both packages' dense engines holding the reference engine's
    seed-0 weights (those of the ``model`` fixture)."""
    cfg, tcfg, _, _ = model
    eng = LLMEngine("t", cfg, max_len=max_len, max_batch=4, seed=0)
    port = TLLMEngine("t", tcfg, max_len=max_len, max_batch=4, device="cpu")
    port.params = bridge.decoder_params(_np_tree(eng.params), tcfg, "cpu")
    return eng, port


def test_engine_ragged_batch_same_greedy_tokens(model):
    """Prompts of 5 and 13 tokens (one S=16 bucket, right-padded), then
    decode_batch with n 4 and 6: identical tokens on both packages, pad
    tokens and overshoot steps absorbed into the state as the reference
    does."""
    rs = np.random.RandomState(6)
    prompts = [rs.randint(1, 1024, n).tolist() for n in (5, 13)]
    outs = []
    for eng in _engine_pair(model):
        sts = [eng.new_state() for _ in prompts]
        eng.prefill_batch(list(zip(sts, prompts)))
        first = [s.last_token for s in sts]
        outs.append((first, eng.decode_batch(list(zip(sts, [4, 6]))),
                     eng.decode_batch([(sts[0], 3)])))
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[1][1]] == [4, 6]


def _greedy_unpadded(cfg, params, apply, as_in, prompt, n):
    """Greedy continuation by re-running the model without a cache on the
    growing unpadded sequence."""
    seq = list(prompt)
    for _ in range(n):
        logits = apply(cfg, params, as_in(np.array([seq], np.int32)))[0]
        seq.append(int(np.argmax(np.asarray(logits[0, -1], np.float32))))
    return seq[len(prompt):]


def test_padded_bucket_prefill_fault_reproduced(model):
    """Reference fault (ROADMAP.md Queue 3): bucketed right-padded prefill
    runs the pad tokens (id 0) through the recurrence, so after the exact
    first token every decoded token comes from a state that absorbed the
    padding. A 5-token prompt in the 8-token bucket decodes differently
    from an unpadded greedy run — identically on both packages; an
    8-token prompt (no padding) matches."""
    cfg, tcfg, jp, tp = model
    ref_eng, port_eng = _engine_pair(model)
    eight = np.random.RandomState(0).randint(1, cfg.vocab_size, 8).tolist()
    for prompt, padded in (([5, 17, 99, 3, 42], True), (eight, False)):
        got = []
        for eng in (ref_eng, port_eng):
            st = eng.new_state()
            eng.prefill_batch([(st, prompt)])
            got.append([st.last_token] + eng.decode_batch([(st, 4)])[0])
        want = _greedy_unpadded(cfg, jp, lambda *a: japply(*a)[:1],
                                jnp.asarray, prompt, 5)
        want_t = _greedy_unpadded(
            tcfg, tp, lambda c, p, x: (tapply(c, p, x)[0].numpy(),),
            torch.from_numpy, prompt, 5)
        assert want == want_t
        assert got[0] == got[1]
        assert got[0][0] == want[0]             # the prefill's own token
        assert (got[0] != want) == padded
