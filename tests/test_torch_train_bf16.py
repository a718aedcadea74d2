"""The port's train step at the reference's default compute dtype,
bfloat16, against the reference's on the same weights (bridged) and
numpy-seeded tokens: the loss, every gradient leaf, and one AdamW step
(loss, ce, gnorm, the new params), for the reduced TinyLlama and RWKV-6
(whose recurrence runs in float32 under any compute dtype, as the
reference's scan step casts r, k, v and w to float32).

Tolerances. bfloat16 keeps 8 significant bits (2^-8 = 3.9e-3 per
rounding), and the packages round at different points: XLA fuses chains
of elementwise ops and rounds once per fusion, torch rounds after every
op. The reference's own bfloat16 gradients lie up to 5.8e-2 of their
leaf's largest magnitude from its float32 ones at these sizes. So the
losses are held at BF16_LOSS_TOL = 1e-3 relative, each gradient leaf and
gnorm at BF16_TOL = 5e-2 of its largest magnitude (never
elementwise-relative), and the new params within 2 lr of the reference's
(Adam's first step is about lr * sign(g), and near-zero gradients can
take either sign)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from test_torch_train import _model, _pairs, _tokens  # noqa: E402

BF16_LOSS_TOL = 1e-3
BF16_TOL = 5e-2
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs (the suite's workers
    otherwise oversubscribe the cores), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(arch):
    cfg, tcfg, jp, tp = _model(arch)
    return cfg, tcfg, jp, tp, _tokens(cfg, 2, 16)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_bf16_loss_and_grads_match_reference(arch):
    cfg, tcfg, jp, tp, toks = _case(arch)
    (jl, jce), jg = jax.jit(jax.value_and_grad(
        lambda p: jts.next_token_loss(cfg, p, jnp.asarray(toks)),
        has_aux=True))(jp)
    tp = tree_map(lambda t: t.clone().requires_grad_(), tp)
    tl, tce = tts.next_token_loss(tcfg, tp, torch.from_numpy(toks))
    assert tl.dtype == torch.float32
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=BF16_LOSS_TOL)
    assert float(tce.detach()) == pytest.approx(float(jce),
                                                rel=BF16_LOSS_TOL)
    tg = tree_map(lambda t: t.grad, tp)
    for path, t, j in _pairs(tg, jg):
        err, scale = float(np.abs(t - j).max()), float(np.abs(j).max())
        assert err <= BF16_TOL * scale, (path, err, scale)
    # the master weights stay float32 and take float32 gradients
    assert all(g.dtype == torch.float32
               for g in jax.tree.leaves(tg, is_leaf=torch.is_tensor))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_bf16_train_step_matches_reference(arch):
    cfg, tcfg, jp, tp, toks = _case(arch)
    joc, toc = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    jp2, _, jm = jax.jit(jts.make_train_step(cfg, joc))(
        jp, jopt.init_opt_state(joc, jp), {"tokens": jnp.asarray(toks)})
    tp = tree_map(torch.clone, tp)
    tp2, _, tm = tts.make_train_step(tcfg, toc)(
        tp, topt.init_opt_state(toc, tp), {"tokens": torch.from_numpy(toks)})
    for k, tol in (("loss", BF16_LOSS_TOL), ("ce", BF16_LOSS_TOL),
                   ("gnorm", BF16_TOL)):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=tol), k
    for path, t, j in _pairs(tp2, jp2):
        assert np.all(np.abs(t - j) <= 2 * OPT["lr"] + 1e-5), path
