"""The port's single-device MoE (repro_torch.models.moe) against the
reference's (repro.models.moe) on the same weights (bridged) and
numpy-seeded tokens: router gates and indices, the load-balance loss, the
routed output of the selected-pairs dispatch against the reference's
``routed_dense`` and against the port's own all-experts
``routed_dense_plain``, and the whole FFN with shared experts, with
``norm_topk_prob`` on and off. The dispatch on the card:
tests/test_torch_cuda.py.

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
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# (experts, top_k, norm_topk_prob): the reduced Qwen (4, 2), and a wider
# router (8 experts, top 4) as Qwen's 60 / 4 and DeepSeek-V3's 256 / 8 are
CASES = [(4, 2, False), (4, 2, True), (8, 4, False), (8, 4, True)]
IDS = [f"E{e}k{k}-{'norm' if n else 'raw'}" for e, k, n in CASES]


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


@pytest.mark.parametrize("experts,topk,norm", CASES, ids=IDS)
def test_routed_output_matches_routed_dense(experts, topk, norm):
    """The selected-pairs dispatch against the reference's all-experts
    ``routed_dense`` and the port's ``routed_dense_plain``: outputs and
    aux losses."""
    cfg, tcfg = _cfgs(experts, topk, norm)
    jp, tp = _params(cfg, tcfg)
    x = _x(cfg, (48,))
    jo, jaux = jmoe.routed_dense(cfg, jp, jnp.asarray(x))
    to, taux = tmoe.routed(tcfg, tp, torch.from_numpy(x))
    po, paux = tmoe.routed_dense_plain(tcfg, tp, torch.from_numpy(x))
    _close_out(to, jo)
    _close_out(po, jo)
    _close_out(to, po.numpy())
    _close(taux, jaux, **TOL)
    _close(paux, jaux, **TOL)


def test_routed_skips_experts_no_token_chose():
    """With one token, only its top-k experts run: the other experts'
    weights may be anything (NaN here) without reaching the output."""
    cfg, tcfg = _cfgs(8, 2, False)
    jp, tp = _params(cfg, tcfg)
    x = torch.from_numpy(_x(cfg, (1,)))
    _, idx, _ = tmoe.router_probs(tcfg, tp["router"], x)
    want, _ = tmoe.routed(tcfg, tp, x)
    for e in set(range(8)) - set(idx[0].tolist()):
        for name in ("w_gate", "w_up", "w_down"):
            tp[name][e] = float("nan")
    got, _ = tmoe.routed(tcfg, tp, x)
    assert torch.equal(got, want)


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
