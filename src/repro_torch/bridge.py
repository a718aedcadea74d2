"""Weight bridge: the reference package's param pytrees, given as numpy
arrays, as the port's params (nested dicts / lists of torch tensors).

The trees keep their structure: decoder stage elements keep the leading
``repeat`` axis of the reference's ``jax.vmap`` init, which the port's
``apply_model`` indexes per layer. Nothing here imports JAX: callers
convert each leaf with ``np.asarray`` first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import leaf_dtype, tree_leaves, tree_map
from repro_torch.models.encoder import EncoderConfig


def to_torch(tree, device="cuda", dtype=None):
    """Map every numpy leaf of a dict/list tree to a torch tensor, cast to
    ``dtype`` where given, except the leaves that the init code, too,
    keeps in float32 (``models.common.leaf_dtype``)."""
    def conv(node, name):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, name) for v in node]
        t = torch.from_numpy(np.array(node, copy=True))
        if dtype is None:
            return t.to(device=device)
        return t.to(device=device, dtype=leaf_dtype(name, dtype))
    return conv(tree, None)


def tree_to(tree, device):
    """Move every tensor of a dict/list params tree to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def decoder_params(tree, cfg: ModelConfig, device="cuda", dtype=None):
    """Params of ``repro.models.transformer.init_params(cfg, ...)`` (numpy
    leaves) -> the port's decoder params."""
    if tuple(np.shape(tree["embed"])) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed shape {np.shape(tree['embed'])} does not "
                         f"match {cfg.name}")
    if len(tree["stages"]) != len(cfg.stages):
        raise ValueError(f"{len(tree['stages'])} stages, {cfg.name} has "
                         f"{len(cfg.stages)}")
    for st, elems in zip(cfg.stages, tree["stages"]):
        if len(elems) != len(st.pattern):
            raise ValueError(f"stage pattern of {len(elems)} elements, "
                             f"expected {len(st.pattern)}")
        for leaf in tree_leaves(elems):
            if np.shape(leaf)[0] != st.repeat:
                raise ValueError(f"stage leaf {np.shape(leaf)} lacks the "
                                 f"leading repeat axis {st.repeat}")
    return to_torch(tree, device, dtype)


def encoder_params(tree, cfg: EncoderConfig, device="cuda", dtype=None):
    """Params of ``repro.models.encoder.init_encoder_params(cfg, ...)``
    (numpy leaves) -> the port's encoder params."""
    if tuple(np.shape(tree["embed"])) != (cfg.vocab_size, cfg.d_model) or \
            len(tree["layers"]) != cfg.num_layers:
        raise ValueError(f"encoder params do not match {cfg.name}")
    return to_torch(tree, device, dtype)
