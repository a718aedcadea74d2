"""The port's single-device MoE (repro_torch.models.moe) against the
reference's (repro.models.moe) on the same weights (bridged) and
numpy-seeded tokens: router gates and indices, the load-balance loss, the
routed output of the selected-pairs dispatch against the reference's
``routed_dense`` and against the port's own all-experts
``routed_dense_plain``, and the whole FFN with shared experts, with
``norm_topk_prob`` on and off. The dispatch takes two forms (the grouped
kernel's plain version ``moe_experts_plain`` on the CPU, and the sorted
per-expert products that need the counts on the host): both are held
against the all-experts forms and against each other, and the rule that
picks one. The dispatch on the card: tests/test_torch_cuda.py.

Tolerances: 1e-5 (absolute and relative) for gates and losses, of order
1; the FFN outputs at 1e-5 relative to their largest magnitude (the
reference draws the stacked expert weights at std 1/sqrt(E), so outputs
reach ~200). Both sides compute in float32 and differ only in summation
order. Every routing decision is checked to have a probability gap far
above float32 rounding, so the top-k choices agree by margin."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.kernels import moe_experts as tmx  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# (experts, top_k, norm_topk_prob): the reduced Qwen (4, 2), and a wider
# router (8 experts, top 4) as Qwen's 60 / 4 and DeepSeek-V3's 256 / 8 are
CASES = [(4, 2, False), (4, 2, True), (8, 4, False), (8, 4, True)]
IDS = [f"E{e}k{k}-{'norm' if n else 'raw'}" for e, k, n in CASES]
# the routed output's cases: each of CASES at 48 random tokens (ids as
# above), then at T = 1, 3, 16 and 64 (T*k above E from 3 on, experts no
# token chose at 1), and 16 copies of one token (every token on the same
# k experts)
ROUTED = [(*c, 48, "random") for c in CASES] + \
    [(*c, T, "random") for T in (1, 3, 16, 64) for c in CASES] + \
    [(*c, 16, "one-token") for c in CASES]
ROUTED_IDS = IDS + [f"{IDS[CASES.index((e, k, n))]}-T{T}-{kind}"
                    for e, k, n, T, kind in ROUTED[4:]]


def _cfgs(experts, topk, norm, shared=True):
    out = []
    for get in (get_config, tget_config):
        base = get("qwen2-moe-a2.7b").reduced()
        mo = dataclasses.replace(
            base.moe, num_experts=experts, top_k=topk, norm_topk_prob=norm,
            num_shared_experts=1 if shared else 0,
            d_shared=base.moe.d_shared if shared else 0)
        out.append(dataclasses.replace(base, moe=mo))
    return out


def _params(cfg, tcfg, seed=0):
    jp = jmoe.init_moe_params(jax.random.key(seed), cfg, jnp.float32)
    return jp, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _x(cfg, shape, seed=1):
    return np.random.RandomState(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _close_out(t, j):
    """Outputs at 1e-5 of their scale."""
    j = np.asarray(j, np.float32)
    _close(t, j, rtol=1e-5, atol=1e-5 * float(np.abs(j).max()))


def _gap(cfg, router, x2d):
    probs = torch.softmax(x2d.float() @ router, dim=-1)
    top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
    return float((top[:, -2] - top[:, -1]).min())


@pytest.mark.parametrize("experts,topk,norm", CASES, ids=IDS)
def test_router_gates_and_indices_match(experts, topk, norm):
    cfg, tcfg = _cfgs(experts, topk, norm)
    jp, tp = _params(cfg, tcfg)
    x = _x(cfg, (64,))
    assert _gap(tcfg, tp["router"], torch.from_numpy(x)) > 1e-5
    jg, ji, jl = jmoe.router_probs(cfg, jp["router"], jnp.asarray(x))
    tg, ti, tl = tmoe.router_probs(tcfg, tp["router"], torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, **TOL)
    _close(tl, jl, **TOL)
    if norm:
        _close(tg.sum(-1), np.ones(64), **TOL)


@pytest.mark.parametrize("experts,topk,norm", CASES, ids=IDS)
def test_aux_loss_matches(experts, topk, norm):
    cfg, tcfg = _cfgs(experts, topk, norm)
    jp, tp = _params(cfg, tcfg)
    x = _x(cfg, (64,))
    jg, ji, jl = jmoe.router_probs(cfg, jp["router"], jnp.asarray(x))
    _close(tmoe.aux_load_balance_loss(tcfg, torch.tensor(np.asarray(jl)),
                                      torch.tensor(np.asarray(ji))),
           jmoe.aux_load_balance_loss(cfg, jl, ji), **TOL)
    # a uniform router over a balanced assignment scores exactly 1
    T, E = 512, experts
    idx = torch.stack([(torch.arange(T) + j) % E for j in range(topk)], -1)
    _close(tmoe.aux_load_balance_loss(tcfg, torch.zeros(T, E), idx),
           1.0, rtol=1e-3)


def _on_path(path, fn, *args):
    """``fn(*args)`` with ``routed`` forced onto ``path``: the grouped
    kernel's form (its crossover lifted) or the sorted one (lowered to 0).
    Returns (result, calls of the kernel's wrapper)."""
    limit, wrapped, calls = tmoe.GROUPED_MAX_ASSIGN, tmoe.moe_experts, []

    def counting(*a):
        calls.append(a[0].shape[0])
        return wrapped(*a)
    tmoe.GROUPED_MAX_ASSIGN = 1 << 30 if path == "grouped" else 0
    tmoe.moe_experts = counting
    try:
        return fn(*args), len(calls)
    finally:
        tmoe.GROUPED_MAX_ASSIGN, tmoe.moe_experts = limit, wrapped


@pytest.mark.parametrize("experts,topk,norm,T,kind", ROUTED, ids=ROUTED_IDS)
def test_routed_output_matches_routed_dense(experts, topk, norm, T, kind):
    """Both forms of the selected-pairs dispatch against the reference's
    all-experts ``routed_dense`` and the port's ``routed_dense_plain``:
    outputs and aux losses; the grouped form (``moe_experts_plain`` on the
    CPU) equal to the sorted one bit for bit, as it runs the same
    per-expert products."""
    cfg, tcfg = _cfgs(experts, topk, norm)
    jp, tp = _params(cfg, tcfg)
    x = _x(cfg, (T,))
    if kind == "one-token":
        x = np.repeat(x[:1], T, axis=0)
    jo, jaux = jmoe.routed_dense(cfg, jp, jnp.asarray(x))
    po, paux = tmoe.routed_dense_plain(tcfg, tp, torch.from_numpy(x))
    _close_out(po, jo)
    _close(paux, jaux, **TOL)
    outs = {}
    for path in ("grouped", "sorted"):
        (to, taux), calls = _on_path(path, tmoe.routed, tcfg, tp,
                                     torch.from_numpy(x))
        assert calls == (path == "grouped")
        _close_out(to, jo)
        _close_out(to, po.numpy())
        _close(taux, jaux, **TOL)
        outs[path] = to
    assert torch.equal(outs["grouped"], outs["sorted"])
    # the kernel's plain version alone, summed over each token's choices
    xt = torch.from_numpy(x)
    gates, idx, _ = tmoe.router_probs(tcfg, tp["router"], xt)
    order, offsets = tmoe._route(experts, idx)
    y = tmx.moe_experts_plain(xt, order, offsets, gates, tp["w_gate"],
                              tp["w_up"], tp["w_down"], tcfg.act, topk)
    assert torch.equal(y.view(T, topk, -1).sum(1), outs["grouped"])
    if kind == "one-token":
        assert int((offsets.diff() == T).sum()) == topk


def test_routed_skips_experts_no_token_chose():
    """With one token, only its top-k experts run, on either form of the
    dispatch: the other experts' weights may be anything (NaN here)
    without reaching the output."""
    cfg, tcfg = _cfgs(8, 2, False)
    jp, tp = _params(cfg, tcfg)
    x = torch.from_numpy(_x(cfg, (1,)))
    _, idx, _ = tmoe.router_probs(tcfg, tp["router"], x)
    want, _ = tmoe.routed(tcfg, tp, x)
    for e in set(range(8)) - set(idx[0].tolist()):
        for name in ("w_gate", "w_up", "w_down"):
            tp[name][e] = float("nan")
    for path in ("grouped", "sorted"):
        (got, _), calls = _on_path(path, tmoe.routed, tcfg, tp, x)
        assert calls == (path == "grouped")
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["no-grad", "under-crossover",
                                  "over-crossover", "autograd",
                                  "params-under-no-grad"])
def test_dispatch_rule(case):
    """``routed`` takes the grouped kernel when no gradient is needed and
    T*k is at or below ``GROUPED_MAX_ASSIGN``, and the sorted path under
    autograd or above it; the span names the path, and only the sorted
    path reads back from the device (a ``readback`` span, and
    ``experts``); under autograd the gradients reach the expert weights."""
    from repro_torch import tracing
    cfg, tcfg = _cfgs(8, 4, False)
    _, tp = _params(cfg, tcfg)
    k = tcfg.moe.top_k
    T = {"over-crossover": tmoe.GROUPED_MAX_ASSIGN // k + 1,
         "under-crossover": tmoe.GROUPED_MAX_ASSIGN // k}.get(case, 6)
    x = torch.from_numpy(_x(cfg, (T,)))
    want = "sorted" if case in ("over-crossover", "autograd") else "grouped"
    if case in ("autograd", "params-under-no-grad"):
        tp = {n: v.requires_grad_() for n, v in tp.items()
              if n != "shared"}
    grad = torch.no_grad() if case in ("no-grad", "params-under-no-grad") \
        else torch.enable_grad()
    tracing.drain()
    tracing.enable()
    try:
        with grad:
            out, _ = tmoe.routed(tcfg, tp, x)
    finally:
        tracing.disable()
    recs = tracing.drain()["records"]
    (span,) = [r for r in recs if r["name"] == "moe.dispatch"]
    kids = [r for r in recs if r["parent"] == span["id"]]
    assert span["path"] == want and span["T"] == T
    if want == "grouped":
        assert kids == [] and "experts" not in span
    else:
        assert [r["name"] for r in kids] == ["readback"]
        assert 1 <= span["experts"] <= 8
    if case == "autograd":
        out.sum().backward()
        assert all(tp[n].grad is not None and
                   bool(tp[n].grad.abs().sum() > 0)
                   for n in ("router", "w_gate", "w_up", "w_down"))


@pytest.mark.parametrize("experts,topk,norm", CASES, ids=IDS)
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "routed"])
def test_moe_ffn_matches(experts, topk, norm, shared):
    """The whole FFN on (B, S, d): routed plus shared experts (or routed
    only), output and aux loss."""
    cfg, tcfg = _cfgs(experts, topk, norm, shared)
    jp, tp = _params(cfg, tcfg)
    assert ("shared" in tp) == shared
    x = _x(cfg, (2, 12))
    jo, jaux = jmoe.moe_ffn(cfg, jp, jnp.asarray(x))
    to, taux = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    _close_out(to, jo)
    _close(taux, jaux, **TOL)
    if shared:
        _close_out(tmoe.shared_expert_ffn(tcfg, tp, torch.from_numpy(x)),
                   jmoe.shared_expert_ffn(cfg, jp, jnp.asarray(x)))
