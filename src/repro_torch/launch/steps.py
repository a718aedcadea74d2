"""Step builders + abstract inputs for every (arch × input shape): the
bridge between the model code and the dry run (PyTorch counterpart of
``repro/launch/steps.py``).

Abstract inputs are meta tensors at ONE rank's local shapes (its slices
by ``launch/shard_rules.py``): the step runs on them under
``mesh_context`` and ``kernels.build.shape_only``, computing shapes and
issuing its collectives (counted by ``models/sharding.py``), with no
memory and no arithmetic. ``q_block`` is every layer's query-block size,
as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import optflags
from repro_torch.launch import shard_rules as sr
from repro_torch.models.sharding import local_shape
from repro_torch.models.transformer import apply_model, param_shapes
from repro_torch.serving import kv_cache as kvc
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def long_context_supported(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic archs: every layer must be
    windowed-attention, SSM, or hybrid (see DESIGN.md skip notes).
    Pure full-attention archs are skipped. gemma2 qualifies via its
    local/global alternation (global layers decode at O(S) with the
    model-sharded cache)."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    if cfg.name.startswith("gemma2"):
        return True
    return False


def case_supported(cfg: ModelConfig, ishape: InputShape):
    if ishape.name == "long_500k" and not long_context_supported(cfg):
        return False, "pure full-attention arch; long_500k skipped (DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------

def num_microbatches(cfg: ModelConfig, ishape: InputShape, mesh) -> int:
    dp = 1
    for a in sr.batch_axes(mesh):
        dp *= mesh.shape[a]
    b_local = max(1, ishape.global_batch // dp)
    # target: ~1 sequence per device per microbatch at 4k train
    m = b_local
    while ishape.global_batch % m:
        m -= 1
    return optflags.get_int("microbatches", max(1, m))


def _meta(shape, dtype, mesh, spec):
    return torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                       device="meta")


def abstract_params(cfg: ModelConfig, mesh, dtype):
    """This rank's param slices, as meta tensors."""
    return sr.shard_tree(param_shapes(cfg, dtype), mesh,
                         specs=sr.model_specs(cfg, mesh))


def abstract_cache(cfg: ModelConfig, mesh, batch: int, max_len: int,
                   chunk: int = 256):
    """This rank's slice of the dense cache (``cache_spec``), as meta
    tensors."""
    return kvc.init_cache(cfg, batch, max_len, chunk=chunk, device="meta",
                          mesh=mesh)


def _inputs(cfg, mesh, B, S, stub):
    if stub:
        shape = (B, S, cfg.d_model)
        return _meta(shape, torch.bfloat16, mesh, sr.data_spec(mesh, shape))
    return _meta((B, S), torch.int32, mesh, sr.data_spec(mesh, (B, S)))


def build_case(cfg: ModelConfig, ishape: InputShape, mesh, *,
               q_block: int = 512):
    """Returns (step_fn, args: tuple, meta: dict). step_fn(*args) is the
    step the dry run runs once on this rank's meta slices; ``pos`` is a
    Python int (the reference's traced scalar)."""
    B, S = ishape.global_batch, ishape.seq_len
    stub = cfg.embed_stub is not None

    if ishape.mode == "train":
        params = abstract_params(cfg, mesh, torch.float32)  # fp32 master
        opt_cfg = AdamWConfig(moment_dtype="bfloat16")
        opt = init_opt_state(opt_cfg, params)
        nmb = num_microbatches(cfg, ishape, mesh)
        step = make_train_step(cfg, opt_cfg, num_microbatches=nmb,
                               compute_dtype=torch.bfloat16, q_block=q_block,
                               stub=stub)
        if stub:
            batch = {"embeds": _inputs(cfg, mesh, B, S, True),
                     "targets": _meta((B, S), torch.int32, mesh,
                                      sr.data_spec(mesh, (B, S)))}
        else:
            batch = {"tokens": _inputs(cfg, mesh, B, S + 1, False)}
        return step, (params, opt, batch), {"microbatches": nmb,
                                            "donate": (0, 1)}

    params = abstract_params(cfg, mesh, torch.bfloat16)
    # prefill writes the whole prompt in one chunk; decode writes 1 token
    cache = abstract_cache(cfg, mesh, B, S,
                           chunk=(S if ishape.mode == "prefill" else 1))

    if ishape.mode == "prefill":
        chunk = optflags.get_int("chunked_prefill", 0)

        if chunk and S % chunk == 0:
            # chunked prefill (the substrate-level form of Teola's
            # Partial/Full Prefilling): transient activations and MoE
            # dispatch buffers scale with the chunk, not the prompt
            def prefill(params, inputs, cache, pos):
                logits = None
                for i in range(S // chunk):
                    logits, cache = apply_model(
                        cfg, params, inputs[:, i * chunk:(i + 1) * chunk],
                        cache, pos + i * chunk, logits_slice=1,
                        q_block=q_block, cache_batch=B)
                return logits, cache
        else:
            def prefill(params, inputs, cache, pos):
                return apply_model(cfg, params, inputs, cache, pos,
                                   logits_slice=1, q_block=q_block,
                                   cache_batch=B)
        inp = _inputs(cfg, mesh, B, S, stub)
        return prefill, (params, inp, cache, 0), {"donate": (2,)}

    # decode: ONE new token against a seq_len KV cache
    def decode(params, inputs, cache, pos):
        return apply_model(cfg, params, inputs, cache, pos, q_block=q_block,
                           cache_batch=B)
    inp = _inputs(cfg, mesh, B, 1, stub)
    return decode, (params, inp, cache, S - 1), {"donate": (2,)}
