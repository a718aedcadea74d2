"""Every configuration of the repo (conftest's ASSIGNED list) trained on
the port against the reference package, at each one's reduced size, on
the same weights (converted by repro_torch.bridge) and numpy-seeded
inputs (tokens, or float embeddings where the modality frontend is
stubbed): the loss and every gradient leaf against jax.value_and_grad of
the reference's loss, then one train step (loss, ce, gnorm, the new
params) against the reference's jitted step, as
tests/test_smoke_archs.py::test_one_train_step runs it.

Tolerances and the sign-flip rule for the new params: see
tests/test_torch_train.py, whose helpers this file uses. MoE routing is
exact top-k on both sides; every routing decision here has a probability
gap above 1e-5, so the comparison holds by margin (checked)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import ASSIGNED  # noqa: E402
from repro.configs.base import get_config  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from test_torch_train import (LOSS_TOL, hold_grads,  # noqa: E402
                              hold_params)

B, S = 2, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)


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


@functools.lru_cache(maxsize=None)
def _model(arch):
    """Both configs, the reference's params, and a batch as numpy, made
    once per arch (the tests copy the port's params before training)."""
    cfg, tcfg = get_config(arch).reduced(), tget_config(arch).reduced()
    jp = jinit(cfg, jax.random.key(0))
    tp = bridge.decoder_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rs = np.random.RandomState(1)
    if cfg.embed_stub:
        batch = {"embeds": rs.standard_normal((B, S, cfg.d_model)).astype(
                     np.float32),
                 "targets": rs.randint(0, cfg.vocab_size, (B, S)).astype(
                     np.int32)}
    else:
        batch = {"tokens": rs.randint(0, cfg.vocab_size, (B, S + 1)).astype(
            np.int32)}
    return cfg, tcfg, jp, tp, batch


def _jloss(cfg, stub):
    def loss(p, b):
        if stub:
            return jts.embed_stub_loss(cfg, p, b["embeds"], b["targets"],
                                       compute_dtype=jnp.float32)
        return jts.next_token_loss(cfg, p, b["tokens"],
                                   compute_dtype=jnp.float32)
    return loss


@functools.lru_cache(maxsize=None)
def _reference_grad(arch):
    """(loss, ce, gradients) of the reference's loss at the initial
    params, once per arch."""
    cfg, _, jp, _, batch = _model(arch)
    (jl, jce), jg = jax.jit(jax.value_and_grad(
        _jloss(cfg, cfg.embed_stub is not None), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    return jl, jce, jg


def _min_router_gap(tcfg, fn):
    """The smallest gap between the k-th and (k+1)-th expert probability
    over every router call while ``fn`` runs (inf without MoE)."""
    gaps, orig = [], tmoe.router_probs

    def traced(cfg, w, x2d):
        probs = torch.softmax(x2d.detach().float() @ w.detach().float(), -1)
        top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return orig(cfg, w, x2d)
    tmoe.router_probs = traced
    try:
        out = fn()
    finally:
        tmoe.router_probs = orig
    return out, min(gaps, default=float("inf"))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_loss_and_grads_match_reference(arch):
    cfg, tcfg, jp, tp, batch = _model(arch)
    stub = cfg.embed_stub is not None
    jl, jce, jg = _reference_grad(arch)
    tp = tree_map(lambda t: t.clone().requires_grad_(), tp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def run():
        if stub:
            return tts.embed_stub_loss(tcfg, tp, tb["embeds"], tb["targets"],
                                       compute_dtype=torch.float32)
        return tts.next_token_loss(tcfg, tp, tb["tokens"],
                                   compute_dtype=torch.float32)
    (tl, tce), gap = _min_router_gap(tcfg, run)
    assert gap > 1e-5
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_TOL)
    assert float(tce.detach()) == pytest.approx(float(jce), rel=LOSS_TOL)
    if cfg.moe is not None:                  # the load-balance loss is in
        assert float(tl.detach()) != float(tce.detach())
    # a leaf that takes no part (the embedding table under embedding
    # inputs) has no .grad; the reference's gradient there is 0
    hold_grads(tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                        else t.grad, tp), jg)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_one_train_step_matches_reference(arch):
    cfg, tcfg, jp, tp, batch = _model(arch)
    stub = cfg.embed_stub is not None
    joc, toc = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    jstep = jax.jit(jts.make_train_step(cfg, joc, compute_dtype=jnp.float32,
                                        q_block=64, stub=stub))
    jb = jax.tree.map(jnp.asarray, batch)
    jp2, _, jm = jstep(jp, jopt.init_opt_state(joc, jp), jb)
    tp = tree_map(torch.clone, tp)
    before = [t.clone() for t in tree_leaves(tp)]
    tstep = tts.make_train_step(tcfg, toc, compute_dtype=torch.float32,
                                stub=stub)
    tp2, _, tm = tstep(tp, topt.init_opt_state(toc, tp),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "gnorm"):
        assert np.isfinite(float(tm[k]))
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=LOSS_TOL), k
    assert not torch.equal(tree_leaves(tp2)[0], before[0])
    hold_params(tp2, jp2, _reference_grad(arch)[2], OPT["lr"])
