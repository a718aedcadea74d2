"""Training launcher of the PyTorch/CUDA port (the counterpart of
``repro/launch/train.py``, with the same flags and printed lines):

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 20 --batch 8 --seq 512 [--reduced] [--microbatches 2] \
      [--ckpt DIR] [--device cuda|cpu]

Trains any configuration (``--reduced``: its smoke-scale variant) on one
device, default the card (``--device cpu`` runs the plain PyTorch
versions of the kernels), eagerly: no ``torch.compile``, no graphs. The
weights are random, drawn from a generator seeded with 0; the data is
``SyntheticLM``. The compute dtype is float32, as in the reference's
launcher, and so are its query blocks of 64 (each checkpointed: a
layer's backward recomputes its attention scores block by block).
Configurations whose modality frontend is stubbed train on one-hot
embeddings of the tokens and need ``--reduced``.

``main(argv)`` returns 0; ``train(args, cfg, params)`` runs the loop on
weights the caller built and returns each step's metrics, so that a
caller (``chip_smoke.py``) can hand it full-width weights.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch.configs.base import get_config
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import init_params
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu")
    return ap


def make_config(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.embed_stub and not args.reduced:
        raise SystemExit("stub-frontend archs train via embeds; use "
                         "--reduced for the local driver")
    return cfg


def make_step(args, cfg):
    """(train_step, AdamWConfig) with the launcher's settings."""
    oc = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    return make_train_step(cfg, oc, num_microbatches=args.microbatches,
                           compute_dtype=torch.float32, q_block=64,
                           stub=cfg.embed_stub is not None), oc


def make_batch(cfg, tokens, device):
    """A SyntheticLM batch (numpy (B, S+1)) as the step's batch."""
    toks = torch.as_tensor(tokens, device=device)
    if cfg.embed_stub is None:
        return {"tokens": toks}
    emb = F.one_hot((toks[:, :-1] % cfg.d_model).long(), cfg.d_model)
    return {"embeds": emb.to(torch.float32), "targets": toks[:, 1:]}


def train(args, cfg, params, log=print):
    """Train ``params`` (float32, on their device) in place for
    ``args.steps`` steps, printing the reference's lines. Returns each
    step's {'loss', 'ce', 'gnorm', 'seconds'} (host clock, the step's
    metrics read back)."""
    device = tree_leaves(params)[0].device
    n = sum(p.numel() for p in tree_leaves(params))
    log(f"[train] {cfg.name}: {n / 1e6:.1f}M params, 1 device(s)")
    step_fn, oc = make_step(args, cfg)
    opt = init_opt_state(oc, params)
    data = SyntheticLM(cfg.vocab_size, batch=args.batch, seq_len=args.seq)
    history = []
    t0 = time.time()
    try:
        for i, batch in enumerate(data):
            if i >= args.steps:
                break
            ts = time.time()
            params, opt, m = step_fn(params, opt,
                                     make_batch(cfg, batch["tokens"], device))
            rec = {k: float(v) for k, v in m.items()}
            rec["seconds"] = time.time() - ts
            history.append(rec)
            if i % 10 == 0 or i == args.steps - 1:
                log(f"[train] step {i:4d} ce={rec['ce']:.4f} "
                    f"({time.time() - t0:.1f}s)")
    finally:
        data.close()
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        log(f"[train] checkpoint saved to {args.ckpt}")
    return history


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = make_config(args)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, torch.float32, device)
    train(args, cfg, params)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
