"""The port's training (repro_torch.training, launch/train.py) against the
reference package on the same weights (bridged) and numpy-seeded inputs:
the learning-rate schedule, AdamW with float32 and bfloat16 moments, the
train step at 1, 2 and 4 microbatches, loss descent, checkpoints in both
directions, the train entry point and the example; and the pieces the
train path needs that serving did not: K6's gradient (the plain backward,
the autograd Function), and the MoE and Mamba layers' gradients. Every
architecture's loss, gradients and train step: test_torch_train_archs.py.
The backward kernel on the card: tests/test_torch_cuda.py.

Tolerances. Both sides compute in float32 and differ only in summation
order. Losses at 1e-5 relative. Gradients at GRAD_TOL = 1e-4 of each
leaf's largest magnitude (never elementwise-relative: near-zero entries
carry the absolute error of the large ones). Parameters after an AdamW
step: Adam's first step moves each parameter by lr * g / (|g| + eps),
about lr * sign(g). An entry whose gradient is below 1e-6 of its leaf's
largest can take the other sign in the other package; one below 1e-4 of
it can come within a few eps (1e-8) after the clip to norm 1, where the
step depends on |g| itself. So entries below FIRM = 1e-4 of their leaf's
largest gradient may move by up to 2 * lr apart, and every other entry is
held at rtol 1e-4, atol 1e-5 (the reference's own
test_microbatch_accumulation_matches_full_batch tolerance is 1e-3 /
1e-5). The gradients themselves are held first, at GRAD_TOL. Layer
outputs are held at OUT_TOL = 1e-5 of their largest magnitude."""
import re
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.examples import train_tiny as ttiny  # noqa: E402
from repro_torch.kernels import rwkv6_scan as tscan  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
FIRM = 1e-4
OUT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs its files in parallel worker processes, and torch's
    own intra-op threads then oversubscribe the cores: this file's small
    torch ops ran up to 100x slower under six workers than alone. So they
    run on one thread here, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(ttree, jtree):
    """(path, port leaf as numpy float32, reference leaf as numpy float32)
    in the reference's order; the paths must agree."""
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = jax.tree_util.tree_flatten_with_path(ttree,
                                              is_leaf=torch.is_tensor)[0]
    assert [jax.tree_util.keystr(p) for p, _ in tl] == \
        [jax.tree_util.keystr(p) for p, _ in jl]
    return [(jax.tree_util.keystr(p), t.detach().float().numpy(),
             np.asarray(j, np.float32)) for (p, t), (_, j) in zip(tl, jl)]


def hold_scaled(t, j, tol=OUT_TOL, what=""):
    """max |t - j| within ``tol`` of max |j|."""
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    err, scale = float(np.abs(t - j).max()), float(np.abs(j).max())
    assert t.shape == j.shape and err <= tol * scale, (what, err, scale)


def hold_grads(tgrads, jgrads, tol=GRAD_TOL):
    for path, t, j in _pairs(tgrads, jgrads):
        scale = float(np.abs(j).max())
        err = float(np.abs(t - j).max())
        assert err <= tol * scale + 1e-12, (path, err, scale)


def hold_params(tparams, jparams, jgrads, lr):
    """The sign-flip rule of the module docstring; jgrads are the
    reference's gradients at the step's start (any scale)."""
    for (path, t, j), g in zip(_pairs(tparams, jparams),
                               jax.tree.leaves(jgrads)):
        g = np.asarray(g, np.float32)
        firm = np.abs(g) >= FIRM * np.abs(g).max()
        np.testing.assert_allclose(t[firm], j[firm], rtol=1e-4, atol=1e-5,
                                   err_msg=path)
        assert np.all(np.abs(t - j) <= 2 * lr + 1e-5), path


def _model(arch, seed=0):
    cfg, tcfg = get_config(arch).reduced(), tget_config(arch).reduced()
    jp = jinit(cfg, jax.random.key(seed))
    return cfg, tcfg, jp, bridge.decoder_params(_np_tree(jp), tcfg, "cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)


# ---------------------------------------------------------------------------
# optimizer

@pytest.mark.parametrize("oc", [
    dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    dict(lr=3e-3, warmup_steps=0, total_steps=7, min_lr_ratio=0.0)])
def test_lr_at_matches_reference(oc):
    jc, tc = jopt.AdamWConfig(**oc), topt.AdamWConfig(**oc)
    for s in (0, 1, 5, 7, 10, 11, 50, 99, 100, 150):
        want = float(jopt.lr_at(jc, jnp.asarray(s)))
        got = topt.lr_at(tc, s)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), s
        assert float(topt.lr_at(tc, torch.tensor(s, dtype=torch.int32))) \
            == float(got)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    """Five updates from identical params and gradients (the warm-up and
    the cosine): params within float32 rounding, moments in their dtype
    (one bfloat16 step where the float32 sums round across a tie)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5,
              moment_dtype=moment_dtype)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    rs = np.random.RandomState(3)
    shapes = {"a": (4, 7), "b": {"c": (16,), "d": (3, 2, 5)}}
    params = jax.tree.map(lambda s: rs.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    jo, to = jopt.init_opt_state(jc, jp), topt.init_opt_state(tc, tp)
    assert to["m"]["a"].dtype == getattr(torch, moment_dtype)
    for i in range(5):
        g = jax.tree.map(
            lambda a: rs.standard_normal(a.shape).astype(np.float32), params)
        jp, jo = jopt.adamw_update(jc, jax.tree.map(jnp.asarray, g), jo, jp)
        tp, to = topt.adamw_update(
            tc, tree_map(lambda a: torch.from_numpy(a), g), to, tp)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        for _, t, j in _pairs(tp, jp):
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
        mtol = 1e-6 if moment_dtype == "float32" else 2 ** -7
        for key in ("m", "v"):
            for _, t, j in _pairs(to[key], jo[key]):
                np.testing.assert_allclose(t, j, rtol=mtol, atol=1e-7)


# ---------------------------------------------------------------------------
# the train step

@pytest.fixture(scope="module")
def tinyllama():
    return _model("tinyllama-1.1b")


@pytest.mark.parametrize("nmb", [1, 2, 4])
def test_train_step_microbatches_match_reference(tinyllama, nmb):
    """loss, ce, gnorm and the new params against the reference's step at
    1, 2 and 4 microbatches (the gradient accumulated over microbatches in
    float32, then divided by their count)."""
    cfg, tcfg, jp, tp = tinyllama
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    toks = _tokens(cfg, 4, 16)
    jstep = jax.jit(jts.make_train_step(
        cfg, jopt.AdamWConfig(**kw), num_microbatches=nmb,
        compute_dtype=jnp.float32, q_block=64))
    jp2, _, jm = jstep(jp, jopt.init_opt_state(jopt.AdamWConfig(**kw), jp),
                       {"tokens": jnp.asarray(toks)})
    tp = tree_map(torch.clone, tp)
    tstep = tts.make_train_step(tcfg, topt.AdamWConfig(**kw),
                                num_microbatches=nmb,
                                compute_dtype=torch.float32)
    tp2, to, tm = tstep(tp, topt.init_opt_state(topt.AdamWConfig(**kw), tp),
                        {"tokens": torch.from_numpy(toks)})
    for k in ("loss", "ce", "gnorm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=LOSS_TOL), k
    assert int(to["step"]) == 1
    grad = jax.grad(lambda p: jts.next_token_loss(
        cfg, p, jnp.asarray(toks), compute_dtype=jnp.float32)[0])(jp)
    hold_params(tp2, jp2, grad, kw["lr"])
    assert all(not p.requires_grad and p.grad is None
               for p in jax.tree.leaves(tp2, is_leaf=torch.is_tensor))


def test_train_step_refuses_indivisible_batch(tinyllama):
    _, tcfg, _, tp = tinyllama
    step = tts.make_train_step(tcfg, topt.AdamWConfig(), num_microbatches=3,
                               compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="microbatches"):
        step(tp, topt.init_opt_state(topt.AdamWConfig(), tp),
             {"tokens": torch.zeros((4, 9), dtype=torch.int32)})


def test_loss_decreases_dense():
    """tests/test_training.py::test_loss_decreases_dense on the port."""
    tcfg = tget_config("tiny-core-llm")
    from repro_torch.models.transformer import init_params as tinit
    params = tinit(tcfg, torch.Generator().manual_seed(0), torch.float32,
                   "cpu")
    oc = topt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30)
    opt = topt.init_opt_state(oc, params)
    step = tts.make_train_step(tcfg, oc, compute_dtype=torch.float32)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, tcfg.vocab_size, (8, 33)).astype(np.int32))
    ces = []
    for _ in range(8):
        params, opt, m = step(params, opt, {"tokens": toks})
        ces.append(float(m["ce"]))
    assert ces[-1] < ces[0] * 0.8


# ---------------------------------------------------------------------------
# checkpoints

def _mixed_numpy():
    """A tree whose dict keys are not in sorted order, with float32,
    bfloat16 and int32 leaves and a list."""
    rs = np.random.RandomState(5)
    return {"wq": rs.standard_normal((2, 3)).astype(np.float32),
            "b": [rs.standard_normal((4,)).astype(np.float32),
                  {"z": np.arange(3, dtype=np.int32),
                   "a": rs.standard_normal((2, 2)).astype(np.float32)}],
            "ab": rs.standard_normal((5,)).astype(np.float32)}


def _bf16(tree_np, to_bf16):
    """Make the leaf at ['b'][1]['a'] bfloat16 on either side."""
    tree_np["b"][1]["a"] = to_bf16(tree_np["b"][1]["a"])
    return tree_np


def test_reference_checkpoint_loads_into_port():
    jtree = jax.tree.map(jnp.asarray, _mixed_numpy())
    jtree["b"][1]["a"] = jtree["b"][1]["a"].astype(jnp.bfloat16)
    like = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32)
                    if a.dtype != np.int32 else torch.zeros(a.shape,
                                                            dtype=torch.int32),
                    _mixed_numpy())
    like["b"][1]["a"] = like["b"][1]["a"].to(torch.bfloat16)
    with tempfile.TemporaryDirectory() as td:
        jckpt.save_checkpoint(td, jtree, step=7)
        back = tckpt.load_checkpoint(td, like)
    assert list(back) == ["wq", "b", "ab"]
    assert back["b"][1]["z"].dtype == torch.int32
    assert back["b"][1]["a"].dtype == torch.bfloat16
    for _, t, j in _pairs(back, jtree):
        np.testing.assert_array_equal(t, j)


def test_port_checkpoint_loads_into_reference():
    ttree = tree_map(torch.from_numpy, _mixed_numpy())
    ttree["b"][1]["a"] = ttree["b"][1]["a"].to(torch.bfloat16)
    like = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray,
                                                     _mixed_numpy()))
    like["b"][1]["a"] = like["b"][1]["a"].astype(jnp.bfloat16)
    with tempfile.TemporaryDirectory() as td:
        tckpt.save_checkpoint(td, ttree, step=3)
        back = jckpt.load_checkpoint(td, like)
        import json
        import os
        with open(os.path.join(td, "manifest.json")) as f:
            man = json.load(f)
    assert man["num_leaves"] == 5 and man["step"] == 3
    assert man["dtypes"] == ["float32", "float32", "bfloat16", "int32",
                             "float32"]
    assert back["b"][1]["a"].dtype == jnp.bfloat16
    for _, t, j in _pairs(ttree, back):
        np.testing.assert_array_equal(t, j)


def test_model_checkpoints_cross_load(tinyllama):
    """A reference model checkpoint into the port's params tree and back:
    bit for bit, and the port's own round trip of the optimizer state."""
    cfg, tcfg, jp, tp = tinyllama
    with tempfile.TemporaryDirectory() as td:
        jckpt.save_checkpoint(td, jp, step=1)
        back = tckpt.load_checkpoint(td, tree_map(torch.zeros_like, tp))
    for _, t, j in _pairs(back, jp):
        np.testing.assert_array_equal(t, j)
    opt = topt.init_opt_state(topt.AdamWConfig(moment_dtype="bfloat16"), tp)
    opt["m"] = tree_map(lambda p: p.to(torch.bfloat16), tp)
    with tempfile.TemporaryDirectory() as td:
        tckpt.save_checkpoint(td, {"params": tp, "opt": opt}, step=2)
        back = tckpt.load_checkpoint(td, {"params": tp, "opt": opt})
        with pytest.raises(ValueError, match="structure mismatch"):
            tckpt.load_checkpoint(td, tp)
    for a, b in zip(jax.tree.leaves({"params": tp, "opt": opt},
                                    is_leaf=torch.is_tensor),
                    jax.tree.leaves(back, is_leaf=torch.is_tensor)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the entry point and the example

def _lines(text):
    """The printed [train] lines without their elapsed times."""
    return [re.sub(r" \([0-9.]+s\)$", "", ln) for ln in text.splitlines()
            if ln.startswith("[train]")]


def test_launch_train_matches_reference_lines(capsys, monkeypatch):
    """The reference's launcher and the port's ``train`` on the
    reference's weights (init key 0): the same lines, the same ce at each
    printed step (4 decimals, within 2e-4), and the checkpoint."""
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--steps", "12",
            "--batch", "4", "--seq", "16"]
    with tempfile.TemporaryDirectory() as td:
        monkeypatch.setattr(sys, "argv", ["train"] + argv + ["--ckpt", td])
        jlaunch.main()
        want = _lines(capsys.readouterr().out)
        cfg, tcfg = get_config("tinyllama-1.1b").reduced(), \
            tget_config("tinyllama-1.1b").reduced()
        tp = bridge.decoder_params(_np_tree(jinit(cfg, jax.random.key(0))),
                                   tcfg, "cpu")
        args = tlaunch.build_parser().parse_args(argv + ["--ckpt", td,
                                                         "--device", "cpu"])
        hist = tlaunch.train(args, tcfg, tp)
        got = _lines(capsys.readouterr().out)
        saved = tckpt.load_checkpoint(td, tree_map(torch.zeros_like, tp))
    assert len(hist) == 12 and len(got) == len(want) == 5
    for g, w in zip(got, want):
        gn, wn = re.findall(r"ce=([0-9.]+)", g), re.findall(r"ce=([0-9.]+)",
                                                            w)
        assert re.sub(r"ce=[0-9.]+", "", g) == re.sub(r"ce=[0-9.]+", "", w)
        assert all(abs(float(a) - float(b)) <= 2e-4 for a, b in zip(gn, wn))
    for a, b in zip(jax.tree.leaves(saved, is_leaf=torch.is_tensor),
                    jax.tree.leaves(tp, is_leaf=torch.is_tensor)):
        assert torch.equal(a, b)


def test_launch_train_main_on_cpu(capsys):
    assert tlaunch.main(["--arch", "musicgen-medium", "--reduced",
                         "--steps", "2", "--batch", "2", "--seq", "8",
                         "--device", "cpu"]) == 0
    lines = _lines(capsys.readouterr().out)
    assert re.fullmatch(r"\[train\] musicgen-medium-smoke: [0-9.]+M params, "
                        r"1 device\(s\)", lines[0])
    assert [ln.split(" ce=")[0] for ln in lines[1:]] == \
        ["[train] step    0", "[train] step    1"]
    with pytest.raises(SystemExit, match="stub-frontend"):
        tlaunch.main(["--arch", "musicgen-medium", "--device", "cpu"])
    assert tlaunch.build_parser().parse_args(
        ["--arch", "x"]).device == "cuda"


def test_example_train_tiny(capsys):
    ttiny.main(steps=3, device="cpu")
    out = capsys.readouterr().out
    assert "checkpoint round-trip OK" in out and "model tiny-core-llm" in out


# ---------------------------------------------------------------------------
# K6's gradient

def _scan_inputs(rs, B, S, H, hd, dtype=np.float32):
    def randn(*shape):
        return rs.standard_normal(shape).astype(dtype)
    r, k, v = [randn(B, S, H, hd) * 0.5 for _ in range(3)]
    w = 1 / (1 + np.exp(-randn(B, S, H, hd))) * 0.5 + 0.4
    return [r, k, v, w.astype(dtype), randn(H, hd) * 0.1,
            randn(B, H, hd, hd) * 0.1]


def test_rwkv6_scan_bwd_plain_matches_reference_grad():
    """The plain backward (boundaries from the plain forward, S = 40: two
    whole chunks of 16 and a partial one) against jax.grad of the
    reference's oracle, ref.rwkv6_scan_ref, for sum(y dy) + sum(S dS)."""
    rs = np.random.RandomState(11)
    xs = _scan_inputs(rs, 2, 40, 3, 8)
    dy = rs.standard_normal((2, 40, 3, 8)).astype(np.float32)
    ds = rs.standard_normal((2, 3, 8, 8)).astype(np.float32)

    def loss(*a):
        y, st = ref.rwkv6_scan_ref(*a)
        return jnp.sum(y * dy) + jnp.sum(st * ds)
    want = jax.grad(loss, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in xs])
    tx = [torch.from_numpy(a) for a in xs]
    bnd = []
    tscan.rwkv6_scan_plain(*tx, boundaries=bnd)
    assert len(bnd) == 3
    got = tscan.rwkv6_scan_bwd_plain(*tx[:5], torch.stack(bnd),
                                     torch.from_numpy(dy),
                                     torch.from_numpy(ds))
    for name, g, w in zip("dr dk dv dw du dstate0".split(), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        assert float(np.abs(g.numpy() - w).max()) <= \
            GRAD_TOL * float(np.abs(w).max()), name


@pytest.mark.parametrize("S", [1, 16, 37])
def test_rwkv6_scan_function_matches_autograd_float64(S):
    """rwkv6_scan under autograd (the Function: plain forward saving the
    boundaries, rwkv6_scan_bwd_plain) against autograd through the plain
    recurrence, in float64, with and without a gradient of the final
    state."""
    rs = np.random.RandomState(S)
    xs = [torch.from_numpy(a) for a in _scan_inputs(rs, 2, S, 2, 8,
                                                    np.float64)]
    dy = torch.from_numpy(rs.standard_normal((2, S, 2, 8)))
    ds = torch.from_numpy(rs.standard_normal((2, 2, 8, 8)))
    for with_state in (False, True):
        a = [x.clone().requires_grad_() for x in xs]
        y, st = tscan.rwkv6_scan(*a)
        assert y.grad_fn is not None and y.dtype == torch.float64
        (y * dy).sum().add((st * ds).sum() if with_state else 0).backward()
        b = [x.clone().requires_grad_() for x in xs]
        y2, st2 = tscan.rwkv6_scan_plain(*b)
        (y2 * dy).sum().add((st2 * ds).sum() if with_state else 0).backward()
        torch.testing.assert_close(y, y2, rtol=0, atol=0)
        for x, z in zip(a, b):
            want = torch.zeros_like(z) if z.grad is None else z.grad
            torch.testing.assert_close(x.grad, want, rtol=1e-10, atol=1e-12)


def test_rwkv6_scan_function_gradcheck():
    rs = np.random.RandomState(2)
    xs = [torch.from_numpy(a).requires_grad_()
          for a in _scan_inputs(rs, 1, 19, 1, 4, np.float64)]
    assert torch.autograd.gradcheck(tscan.RWKV6Scan.apply, xs, eps=1e-6,
                                    atol=1e-6, rtol=1e-5)


def test_rwkv6_scan_grad_dtypes_and_out_state():
    """bfloat16 inputs get bfloat16 gradients (float32 u and state get
    float32); a serving cache update (out_state) is refused under
    autograd; without an input that requires grad nothing changes."""
    rs = np.random.RandomState(4)
    xs = [torch.from_numpy(a) for a in _scan_inputs(rs, 1, 5, 2, 8)]
    a = [x.to(torch.bfloat16).requires_grad_() for x in xs[:4]] + \
        [x.clone().requires_grad_() for x in xs[4:]]
    y, st = tscan.rwkv6_scan(*a)
    (y.sum() + st.sum()).backward()
    assert [x.grad.dtype for x in a] == [torch.bfloat16] * 4 + \
        [torch.float32] * 2
    with pytest.raises(ValueError, match="out_state"):
        tscan.rwkv6_scan(*a, out_state=torch.empty_like(xs[5]))
    out = torch.empty_like(xs[5])
    y, st = tscan.rwkv6_scan(*xs, out_state=out)
    assert st is out and y.grad_fn is None


# ---------------------------------------------------------------------------
# MoE and Mamba layers under autograd

def _layer0(tree):
    return tree_map(lambda t: t[0], tree)


def _grads_of(fn, leaves, cot):
    """Port gradients of sum(out_i * cot_i) with respect to ``leaves``."""
    leaves = tree_map(lambda t: t.clone().requires_grad_(), leaves)
    outs = fn(leaves)
    loss = sum((o * torch.from_numpy(np.asarray(c))).sum()
               for o, c in zip(outs, cot))
    gs = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(gs)
    return outs, tree_map(lambda _: next(it), leaves)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_moe_layer_grads_match_reference(arch):
    """moe_ffn (selected pairs, expert slices concatenated under autograd)
    and its load-balance loss against the reference's routed_dense:
    outputs, and the gradients of every expert, the router and the input.
    Every routing decision has a probability gap above 1e-5."""
    cfg, tcfg, jp, tp = _model(arch)
    si = next(i for i, st in enumerate(cfg.stages)
              if any(s.moe for s in st.pattern))
    ei = next(i for i, s in enumerate(cfg.stages[si].pattern) if s.moe)
    jm = jax.tree.map(lambda a: a[0], jp["stages"][si][ei]["moe"])
    tm = _layer0(tp["stages"][si][ei]["moe"])
    rs = np.random.RandomState(7)
    x = rs.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    cot = [rs.standard_normal(x.shape).astype(np.float32), np.float32(0.7)]
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, cfg.d_model))
                          @ tm["router"], -1)
    top = torch.topk(probs, cfg.moe.top_k + 1, -1).values
    assert float((top[:, -2] - top[:, -1]).min()) > 1e-5

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(cfg, p, xx)
        return jnp.sum(out * cot[0]) + aux * cot[1], (out, aux)
    (_, (jo, ja)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jm, jnp.asarray(x))
    (to, ta), tg = _grads_of(
        lambda lv: tmoe.moe_ffn(tcfg, lv["p"], lv["x"]),
        {"p": tm, "x": torch.from_numpy(x)}, cot)
    hold_scaled(to, jo, what="out")
    assert float(ta.detach()) == pytest.approx(float(ja), rel=1e-5)
    hold_grads(tg["p"], jg)
    hold_grads({"x": tg["x"]}, {"x": jgx})


def test_mamba_branch_grads_match_reference():
    """Hymba's Mamba branch (the step loop stacked under autograd) against
    the reference's chunked scan: outputs and the final state, and the
    gradients of every branch weight, the input and the carried state."""
    cfg, tcfg, jp, tp = _model("hymba-1.5b")
    jm = jax.tree.map(lambda a: a[0], jp["stages"][0][0]["mamba"])
    tm = _layer0(tp["stages"][0][0]["mamba"])
    s, d = cfg.ssm, cfg.d_model
    rs = np.random.RandomState(9)
    x = rs.standard_normal((2, 20, d)).astype(np.float32)
    h0 = rs.standard_normal((2, d, s.state_dim)).astype(np.float32) * 0.1
    c0 = rs.standard_normal((2, s.conv_dim - 1, d)).astype(np.float32)
    cot = [rs.standard_normal((2, 20, d)).astype(np.float32),
           rs.standard_normal(h0.shape).astype(np.float32)]

    def jloss(p, xx, hh):
        out, h, _ = jssm.mamba_branch(cfg, p, xx, hh, jnp.asarray(c0))
        return jnp.sum(out * cot[0]) + jnp.sum(h * cot[1]), (out, h)
    (_, (jo, jh)), (jg, jgx, jgh) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jm, jnp.asarray(x),
                                                jnp.asarray(h0))
    (to, th), tg = _grads_of(
        lambda lv: tssm.mamba_branch(tcfg, lv["p"], lv["x"], lv["h"],
                                     torch.from_numpy(c0))[:2],
        {"p": tm, "x": torch.from_numpy(x), "h": torch.from_numpy(h0)}, cot)
    hold_scaled(to, jo, what="out")
    hold_scaled(th, jh, what="h")
    hold_grads(tg["p"], jg)
    hold_grads({"x": tg["x"], "h": tg["h"]}, {"x": jgx, "h": jgh})
