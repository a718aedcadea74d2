"""Training-substrate example (the port's counterpart of
``examples/train_tiny.py``): train the engine-scale core LLM for a few
hundred steps on the synthetic pipeline, then round-trip a checkpoint.

  PYTHONPATH=src python -m repro_torch.examples.train_tiny [steps] \
      [--device cuda|cpu]

Runs on the card unless ``--device cpu``. The checkpoint is written under
a temporary directory and removed afterwards.
"""
import argparse
import tempfile
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import init_params
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def main(steps=200, device="cuda"):
    cfg = get_config("tiny-core-llm")
    device = torch.device(device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         torch.float32, device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params")

    oc = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    opt = init_opt_state(oc, params)
    step_fn = make_train_step(cfg, oc, num_microbatches=2,
                              compute_dtype=torch.float32)
    data = SyntheticLM(cfg.vocab_size, batch=8, seq_len=64)
    t0 = time.time()
    try:
        for i, batch in enumerate(data):
            if i >= steps:
                break
            batch = {"tokens": torch.as_tensor(batch["tokens"],
                                               device=device)}
            params, opt, m = step_fn(params, opt, batch)
            if i % 20 == 0 or i == steps - 1:
                print(f"step {i:4d}  ce={float(m['ce']):.4f}  "
                      f"gnorm={float(m['gnorm']):.3f}  "
                      f"{(time.time() - t0):.1f}s")
    finally:
        data.close()
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, params, step=steps)
        restored = load_checkpoint(td, params)
    if not all(torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(restored))):
        raise RuntimeError("checkpoint round trip changed the weights")
    print(f"checkpoint round-trip OK; final ce={float(m['ce']):.4f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.steps, args.device)
