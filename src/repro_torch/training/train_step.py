"""Training step: next-token cross-entropy + AdamW, with microbatch
gradient accumulation (PyTorch counterpart of
``repro/training/train_step.py``).

Master weights float32; the forward runs on a copy of every floating leaf
cast to ``compute_dtype`` (the router and the other leaves that init keeps
in float32 included, as the reference casts them), and the master weights
get their gradients through the cast. The MoE load-balance loss is added
with ``AUX_COEF``. Microbatches are a loop where the reference scans: each
one's gradients are added into the leaves' ``.grad`` in float32, then
divided by the count. The gradients' global norm is clipped to 1 before
AdamW.

The attention of a training forward is the plain masked attention over
blocks of ``q_block`` queries (``models/attention.py::blockwise_over_q``,
the reference's ``q_block``), each block checkpointed: the backward
recomputes a block's scores, so that no layer keeps its whole (B, K, G,
S, S) float32 scores and probabilities (for TinyLlama-1.1B at 4 x 512
tokens per microbatch 134 MB each per layer unblocked, about 6 GB over 22
layers). The ``causal_skip`` flag also skips the blocks above the
diagonal.

Under ``models.sharding.mesh_context(mesh)`` the step is the sharded
one: params, moments and batch are this rank's slices
(``launch/shard_rules.py``), and the loss is averaged over the batch
axes. Each rank back-propagates its loss divided by the mesh size (every
rank's loss is the mean over its rows, and the ranks that share rows
hold equal copies), so that, the collectives being exact adjoints
(``models/sharding.py``), the sum over the ranks that hold a param is its
gradient: FSDP-sharded leaves come back reduce-scattered through their
gather's backward, and every leaf is then all-reduced over the mesh axes
it is replicated on. The global norm sums each leaf's squared local
shard over the axes that shard it, so a replicated leaf counts once.
AdamW then updates the local shards.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.sharding import active_mesh, all_reduce, entry_axes
from repro_torch.models.transformer import apply_model
from repro_torch.training.optimizer import AdamWConfig, adamw_update

AUX_COEF = 0.01


def _cast(params, compute_dtype):
    return tree_map(lambda p: p.to(compute_dtype)
                    if p.is_floating_point() else p, params)


def _ce(logits, targets):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long()).squeeze(-1)
    return torch.mean(logz - gold)


def next_token_loss(cfg, params, tokens, *, compute_dtype=torch.bfloat16,
                    q_block=512):
    """tokens (B, S+1): inputs tokens[:, :-1] predict tokens[:, 1:].
    Returns (loss, ce)."""
    logits, _, aux = apply_model(cfg, _cast(params, compute_dtype),
                                 tokens[:, :-1], return_aux=True,
                                 q_block=q_block)
    ce = _ce(logits, tokens[:, 1:])
    return ce + AUX_COEF * aux, ce


def embed_stub_loss(cfg, params, embeds, targets, *,
                    compute_dtype=torch.bfloat16, q_block=512):
    """For modality-stub archs: inputs are precomputed frame/patch
    embeddings (B,S,d); targets (B,S) token ids. Returns (loss, ce)."""
    logits, _, aux = apply_model(cfg, _cast(params, compute_dtype), embeds,
                                 return_aux=True, q_block=q_block)
    ce = _ce(logits, targets)
    return ce + AUX_COEF * aux, ce


def _sync_sharded(cfg, grads, mesh):
    """The sharded step's gradients: each leaf's summed over the mesh axes
    it is replicated on; and the global norm over every leaf's shards.
    Returns gnorm."""
    from repro_torch.launch.shard_rules import model_specs
    specs = model_specs(cfg, mesh)
    sq = {}

    def one(g, spec):
        axes = tuple(a for e in spec for a in entry_axes(e))
        rep = tuple(a for a in mesh.axis_names if a not in axes)
        if rep:
            g.copy_(all_reduce(g, rep))
        key = mesh.ordered(axes)
        sq[key] = sq.get(key, 0.0) + torch.sum(torch.square(g.float()))
        return g
    tree_map(one, grads, specs)
    total = sum(all_reduce(v, axes) if axes else v
                for axes, v in sorted(sq.items()))
    return torch.sqrt(total)


def make_train_step(cfg, opt_cfg: AdamWConfig, *, num_microbatches: int = 1,
                    compute_dtype=torch.bfloat16, q_block: int = 512,
                    stub: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), params and moments updated in place. batch: {'tokens':
    (B,S)} or {'embeds': (B,S,d), 'targets': (B,S)} for stub archs, on the
    params' device. B must divide by num_microbatches. metrics: {'loss',
    'ce', 'gnorm'}, 0-dim float32 tensors."""

    def loss_fn(params, mb):
        if stub:
            return embed_stub_loss(cfg, params, mb["embeds"], mb["targets"],
                                   compute_dtype=compute_dtype,
                                   q_block=q_block)
        return next_token_loss(cfg, params, mb["tokens"],
                               compute_dtype=compute_dtype, q_block=q_block)

    def train_step(params, opt_state, batch):
        mesh = active_mesh()
        leaves = tree_leaves(params)
        B = next(iter(batch.values())).shape[0]
        if B % num_microbatches:
            raise ValueError(f"batch {B} does not divide into "
                             f"{num_microbatches} microbatches")
        n = B // num_microbatches
        loss = ce = torch.zeros((), dtype=torch.float32,
                                device=leaves[0].device)
        try:
            for p in leaves:
                p.grad = None
                p.requires_grad_(True)
            with torch.enable_grad():
                for i in range(num_microbatches):
                    mb = {k: a[i * n:(i + 1) * n] for k, a in batch.items()}
                    l, c = loss_fn(params, mb)
                    (l if mesh is None else l / mesh.size).backward()
                    loss, ce = loss + l.detach(), ce + c.detach()
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32) if p.grad is None else p.grad, params)
        finally:
            for p in leaves:
                p.requires_grad_(False)
                p.grad = None
        if num_microbatches > 1:
            for g in tree_leaves(grads):
                g.div_(num_microbatches)
            loss, ce = loss / num_microbatches, ce / num_microbatches
        if mesh is None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in tree_leaves(grads)))
        else:
            gnorm = _sync_sharded(cfg, grads, mesh)
            loss = all_reduce(loss, mesh.axis_names) / mesh.size
            ce = all_reduce(ce, mesh.axis_names) / mesh.size
        scale = torch.minimum(torch.ones_like(gnorm), 1.0 / (gnorm + 1e-9))
        for g in tree_leaves(grads):
            g.mul_(scale)
        params, opt_state = adamw_update(opt_cfg, grads, opt_state, params)
        return params, opt_state, {"loss": loss, "ce": ce, "gnorm": gnorm}

    return train_step
