"""Composable decoder model: init + apply for every configuration
(PyTorch counterpart of ``repro/models/transformer.py``).

Params keep the reference's pytree layout, as a nested dict of tensors:
``{'embed', 'final_norm', 'lm_head'?, 'stages': [[elem, ...], ...]}``
where each stage element's tensors carry a leading ``repeat`` axis (the
reference's ``jax.vmap`` init). ``apply_model`` walks the repeats in a
Python loop where the reference scans. The same call serves training
(cache=None, full causal), chunked prefill (cache + pos offset — Teola's
Partial/Full Prefilling) and decode (S == 1).

A layer is GQA or MLA attention (``models/attention.py``), in a hybrid
layer fused with a parallel Mamba branch (Hymba), followed by a dense or
a mixture-of-experts FFN (``models/moe.py``); or an RWKV-6 layer. Inputs
are tokens, or float embeddings ``(B, S, d)`` for the configurations
whose modality frontend is stubbed (``embed_stub``).

``block_tables`` switches the cache to the paged pool (serving/
kv_cache.py); ``verify=True`` marks a speculative verify chunk on it.

Recurrent layers (RWKV-6, the Mamba branch) keep a per-sequence state in
the dense cache (``state``, ``sx_tm``, ``sx_cm``; ``ssm_h``, ``ssm_conv``),
updated in place; they ignore ``pos``.

Under ``models.sharding.mesh_context(mesh)`` ``apply_model`` runs
explicit SPMD code on this rank's slices of the params
(``launch/shard_rules.py::shard_tree``), its rows of the batch and its
slice of the dense cache (``serving/kv_cache.py::init_cache``, the
reference's layout: the sequence over 'model'): a vocab-parallel
embedding (rows over 'model', masked lookup, all-reduce); each weight's
FSDP-sharded dims all-gathered at use and dropped after the layer
(ZeRO-3); without a cache, GQA over the rank's query heads where
``shard_rules.head_parallel`` (``wq``/``wk``/``wv`` column-parallel, ``wo``
row-parallel, then an all-reduce over 'model'); on a dense cache, GQA
and MLA compute every head's q, k, v from the local columns, write the
rank's sequence slots, attend over them with each row's log-sum-exp and
merge the partials over the sequence axes (``_gqa_seq_sharded``); MLA
over the rank's heads (``_mla_sharded``); RWKV's time mix over the rank's
heads and its channel mix over its share of f, Mamba over its share of
dI (``models/ssm.py``), with their states split as the cache spec splits
them; the dense FFN column- then row-parallel, then an all-reduce; MoE
through expert parallelism (``models/moe.py``); a vocab-parallel head
all-gathered over 'model' into full logits. Each leaf's layout is read
from its spec, never assumed; where a rule does not split a dim the
layer needs split, its block is cut from the gathered leaf. The paged
pool is not sharded (the reference shards only the dense cache): there
every rank computes every head.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.common import (act_fn, dense_init, embed_init,
                                       rms_norm, softcap, tree_map)
from repro_torch.models.sharding import (active_mesh, all_gather,
                                         all_reduce, entry_axes, materialize,
                                         materialize_tree, merge_partials,
                                         model_span)


# ---------------------------------------------------------------------------
# init

def init_layer_elem(generator, cfg: ModelConfig, spec: LayerSpec, dtype,
                    device, repeat: int):
    d, f = cfg.d_model, cfg.d_ff

    def zeros():
        return torch.zeros((repeat, d), dtype=dtype, device=device)

    p = {"ln1": zeros(), "ln2": zeros()}
    if spec.kind == "rwkv":
        p.update(ssm.init_rwkv_params(generator, cfg, dtype, device, repeat))
        return p
    init_attn = attn.init_mla_params if cfg.attention_kind == "mla" else \
        attn.init_gqa_params
    p["attn"] = init_attn(generator, cfg, dtype, device, repeat)
    if spec.kind == "hybrid":
        p["mamba"] = ssm.init_mamba_params(generator, cfg, dtype, device,
                                           repeat)
        p["fuse_na"] = zeros()
        p["fuse_ns"] = zeros()
    if spec.moe:
        p["moe"] = moe.init_moe_params(generator, cfg, dtype, device, repeat)
    else:
        p["mlp"] = {
            "w_gate": dense_init(generator, (repeat, d, f), dtype, device,
                                 fan_in=d),
            "w_up": dense_init(generator, (repeat, d, f), dtype, device,
                               fan_in=d),
            "w_down": dense_init(generator, (repeat, f, d), dtype, device,
                                 fan_in=f),
        }
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                dtype=torch.float32, device="cuda"):
    """Random weights with the reference ``init_params``'s shapes and
    scales, drawn from ``generator`` on the generator's device and placed
    on ``device`` (``generator=None``: torch's default generator on
    ``device``)."""
    params = {"embed": embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                  dtype, device),
              "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                        device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype, device)
    params["stages"] = [
        [init_layer_elem(generator, cfg, spec, dtype, device, st.repeat)
         for spec in st.pattern]
        for st in cfg.stages]
    return params


def param_shapes(cfg: ModelConfig, dtype=torch.bfloat16):
    """Abstract param tree (meta tensors: nothing allocated, nothing
    drawn) — used by the sharding rules and the dry run."""
    return init_params(cfg, None, dtype, device="meta")


# ---------------------------------------------------------------------------
# apply

def _ffn(cfg, p, x):
    act = act_fn(cfg.act)
    h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def _rwkv_layer(cfg, p, x, ce):
    """norm -> time mix -> residual, norm -> channel mix -> residual. With
    a cache elem the new state and token-shift rows are written into its
    views in place; without one the state starts at zeros."""
    B, _, d = x.shape
    if ce is None:
        hd = cfg.ssm.head_dim
        state = torch.zeros((B, d // hd, hd, hd), dtype=torch.float32,
                            device=x.device)
        sx_tm = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        sx_cm = torch.zeros_like(sx_tm)
    else:
        state, sx_tm, sx_cm = ce["state"], ce["sx_tm"], ce["sx_cm"]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out, _, new_sx_tm = ssm.rwkv_time_mix(
        cfg, p["tm"], h, state, sx_tm,
        out_state=None if ce is None else state)
    x = x + out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    out, new_sx_cm = ssm.rwkv_channel_mix(cfg, p["cm"], h, sx_cm)
    x = x + out
    if ce is not None:
        sx_tm.copy_(new_sx_tm)
        sx_cm.copy_(new_sx_cm)
    return x, ce


def _hybrid_state(cfg, ce, B, device):
    """The Mamba branch's (h, conv) state: the cache's views, or zeros."""
    if ce is not None:
        return ce["ssm_h"], ce["ssm_conv"]
    s, d = cfg.ssm, cfg.d_model
    return (torch.zeros((B, d, s.state_dim), dtype=torch.float32,
                        device=device),
            torch.zeros((B, s.conv_dim - 1, d), dtype=torch.float32,
                        device=device))


# ---------------------------------------------------------------------------
# the sharded layer (explicit SPMD under an active mesh)

def _whole_repeat(tree, specs):
    """A stage element's leaves with their repeat dim gathered where its
    spec shards it (the rules treat a stacked MoE shared expert's
    (R, d, f) as expert-stacked, so R can split over 'model')."""
    if isinstance(tree, dict):
        return {k: _whole_repeat(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_whole_repeat(v, s) for v, s in zip(tree, specs)]
    return tree if specs[0] is None else all_gather(tree, specs[0], 0)


def _layer_specs(specs):
    """A stage element's spec tree with the leading repeat entry
    dropped: the specs of one layer's leaves."""
    if isinstance(specs, dict):
        return {k: _layer_specs(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_layer_specs(v) for v in specs]
    return specs[1:]


def _seq_entry(name, mesh, cache_batch):
    """The spec entry of the cache leaf ``name``'s sequence dim."""
    from repro_torch.launch.shard_rules import cache_spec
    return cache_spec(name, (1, cache_batch, 1, 1), mesh,
                      batch=cache_batch)[2]


def _seq_slice(t, mesh, seq):
    """(first, total): the global slots of this rank's slice of a cache
    leaf's sequence dim (t: the layer's (B, T_local, ...) view), split
    over the spec entry ``seq``."""
    axes = entry_axes(seq)
    n = t.shape[1]
    if not axes:
        return 0, n
    return mesh.index(axes) * n, mesh.group_size(axes) * n


def _cols(x, p, ps, name, bias=None):
    """x @ p[name] through this rank's columns, all-gathered over 'model'
    where the leaf's columns split there (then every rank holds every
    column, whether or not the split falls between heads)."""
    y = x @ materialize(p[name], ps[name], keep=1)
    if bias is not None:
        y = y + materialize(p[bias], ps[bias], keep=0)
    return all_gather(y, "model", -1) if ps[name][-1] == "model" else y


def _rows_out(o, p, ps, name, mesh):
    """o (..., n) @ p[name] (n, d): where the leaf's rows split over
    'model', this rank's rows of o through its rows, all-reduced over
    'model'; o @ the whole leaf otherwise."""
    w = materialize(p[name], ps[name], keep=0)
    if ps[name][0] != "model":
        return o @ w
    start, n = model_span(o.shape[-1], mesh)
    return all_reduce(o[..., start:start + n] @ w, "model")


def _gqa_sharded(cfg, spec, p, ps, h, ce, pos, block_tables, verify, mesh,
                 q_block, cache_batch):
    """GQA under a mesh. On a dense cache: the reference's sequence layout
    (``_gqa_seq_sharded``). Without a cache: over this rank's query heads
    where ``head_parallel`` (the local columns of wq, the KV heads those
    heads read, the local rows of wo, then an all-reduce over 'model'),
    every head on every rank otherwise. On the paged pool, which is not
    sharded (as in the reference), every head on every rank."""
    from repro_torch.launch.shard_rules import head_parallel
    if ce is not None and block_tables is None:
        return _gqa_seq_sharded(cfg, spec, p, ps, h, ce, pos, mesh, q_block,
                                cache_batch)
    if ce is not None or not head_parallel(cfg, mesh):
        return attn.gqa_layer(cfg, spec, materialize_tree(p, ps), h, ce,
                              pos, block_tables, verify, q_block)[0]
    tp, r = mesh.shape["model"], mesh.index("model")
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    lp = {"wq": materialize(p["wq"], ps["wq"], keep=1),
          "wo": materialize(p["wo"], ps["wo"], keep=0)}
    if cfg.qkv_bias:
        lp["bq"] = materialize(p["bq"], ps["bq"], keep=0)
    kv = ("wk", "wv") + (("bk", "bv") if cfg.qkv_bias else ())
    if K % tp == 0:
        for n in kv:
            lp[n] = materialize(p[n], ps[n], keep=p[n].dim() - 1)
        Kl = K // tp
    else:                       # tp % K == 0: the one KV head read here
        j = r * K // tp
        for n in kv:
            lp[n] = materialize(p[n], ps[n])[..., j * hd:(j + 1) * hd]
        Kl = 1
    if (lp["wq"].shape[-1], lp["wo"].shape[0], lp["wk"].shape[-1]) != \
            (H // tp * hd, H // tp * hd, Kl * hd):
        raise ValueError(f"wq/wo/wk specs {ps['wq']} {ps['wo']} {ps['wk']}"
                         f" do not split whole heads over 'model'")
    lcfg = dataclasses.replace(cfg, num_heads=H // tp, num_kv_heads=Kl,
                               head_dim=hd)
    out, _ = attn.gqa_layer(lcfg, spec, lp, h, None, pos, q_block=q_block)
    return all_reduce(out, "model")


def _gqa_seq_sharded(cfg, spec, p, ps, h, ce, pos, mesh, q_block,
                     cache_batch):
    """GQA on this rank's slice of a sequence-split dense cache (the
    reference's layout, ``shard_rules.cache_spec``): q, k and v of the S
    new tokens through the local columns of wq / wk / wv, all-gathered over
    'model' (every head: a split of MusicGen's 24 heads over 16 ranks
    falls mid-head); k and v written into the slots this rank owns; every
    head attends over the local slots (K1 / K2 with their LSE, the plain
    core on a windowed ring); the partials merged over the sequence axes
    (``merge_partials``); then wo's local rows and an all-reduce."""
    B, S, _ = h.shape
    bias = cfg.qkv_bias
    q, k, v, _, positions = attn.gqa_qkv(
        cfg, p, h, pos, lambda n, b: _cols(h, p, ps, n, b if bias else None))
    seq = _seq_entry("k", mesh, cache_batch)
    o, lse = attn.attend_slice(q, k, v, ce, pos, positions,
                               _seq_slice(ce["k"], mesh, seq),
                               window=spec.window,
                               cap=cfg.attn_logit_softcap,
                               scale=attn.gqa_scale(cfg), q_block=q_block)
    o = merge_partials(o, lse, seq)
    return _rows_out(o.reshape(B, S, -1), p, ps, "wo", mesh)


def _mla_sharded(cfg, spec, p, ps, h, ce, pos, block_tables, mesh, q_block,
                 cache_batch):
    """MLA under a mesh, over this rank's heads where ``wq_b`` / ``wkv_b``
    columns and ``wo`` rows split by whole heads over 'model' (H divides;
    no flat_dp), every head otherwise. ``wq_a``'s column-parallel output
    is all-gathered before ``q_norm``; ``wkv_a`` has no 'model' split, so
    the new ckv / krope are whole on every rank. On a dense cache (the
    sequence over 'model') the local heads' q_eff / q_rope are
    all-gathered, every head attends over the local slots with its LSE,
    the partials merge over the sequence axes and each rank keeps its
    heads' context. The paged pool is not sharded: every head, whole
    weights."""
    from repro_torch.launch import optflags
    if block_tables is not None:
        return attn.mla_layer(cfg, spec, materialize_tree(p, ps), h, ce,
                              pos, block_tables, q_block)[0]
    H = cfg.num_heads
    tp = mesh.shape.get("model", 1)
    hp = H % tp == 0 and not optflags.has("flat_dp") and \
        ps["wq_b"][-1] == ps["wkv_b"][-1] == ps["wo"][0] == "model"
    lp = {"wkv_a": materialize(p["wkv_a"], ps["wkv_a"]),
          "kv_norm": materialize(p["kv_norm"], ps["kv_norm"])}
    for n, dim in (("wq_b", 1), ("wkv_b", 1), ("wo", 0)):
        lp[n] = materialize(p[n], ps[n], keep=dim) if hp else \
            materialize(p[n], ps[n])
    cq = rms_norm(_cols(h, p, ps, "wq_a"),
                  materialize(p["q_norm"], ps["q_norm"]), cfg.norm_eps)
    q_eff, q_rope, ckv_new, krope_new, wv, _, positions = \
        attn.mla_project(cfg, lp, h, pos, cq)
    scale = attn.mla_scale(cfg)
    if ce is None:
        ctx = attn.mla_attention(q_eff, q_rope, ckv_new, krope_new,
                                 positions, positions, scale=scale,
                                 window=spec.window, q_block=q_block)
    else:
        if hp:
            q_eff = all_gather(q_eff, "model", 2)
            q_rope = all_gather(q_rope, "model", 2)
        seq = _seq_entry("ckv", mesh, cache_batch)
        ctx, lse = attn.mla_attend_slice(
            q_eff, q_rope, ckv_new, krope_new, ce, pos, positions,
            _seq_slice(ce["ckv"], mesh, seq), scale=scale,
            window=spec.window, q_block=q_block)
        ctx = merge_partials(ctx, lse, seq)
        if hp:
            ctx = ctx.narrow(2, *model_span(H, mesh))
    B, S, _ = h.shape
    out = torch.einsum("bshr,rhv->bshv", ctx, wv).reshape(B, S, -1) @ \
        lp["wo"]
    return all_reduce(out, "model") if hp else out


def _rwkv_sharded(cfg, p, ps, x, ce, mesh, cache_batch):
    """An RWKV layer under a mesh: the time mix over this rank's heads
    (``ssm.rwkv_time_mix_tp``) where ``ssm.rwkv_tp`` says so, the channel
    mix with f over 'model' (``ssm.rwkv_channel_mix_tp``) where f divides;
    whole otherwise. The state cache holds H / tp heads exactly where the
    time mix is split (``shard_rules.cache_spec``)."""
    from repro_torch.launch.shard_rules import cache_spec
    B, _, d = x.shape
    hd = cfg.ssm.head_dim
    H = d // hd
    st_spec = None if ce is None else cache_spec(
        "state", (1, cache_batch, H, hd, hd), mesh, batch=cache_batch)
    tp = ssm.rwkv_tp(cfg, mesh, st_spec)
    if ce is None:
        Hl = H // mesh.shape["model"] if tp else H
        state = torch.zeros((B, Hl, hd, hd), dtype=torch.float32,
                            device=x.device)
        sx_tm = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        sx_cm = torch.zeros_like(sx_tm)
    else:
        state, sx_tm, sx_cm = ce["state"], ce["sx_tm"], ce["sx_cm"]
    out_state = None if ce is None else state
    h = rms_norm(x, materialize(p["ln1"], ps["ln1"]), cfg.norm_eps)
    if tp:
        out, _, new_sx_tm = ssm.rwkv_time_mix_tp(
            cfg, p["tm"], ps["tm"], h, state, sx_tm, out_state, mesh)
    else:
        out, _, new_sx_tm = ssm.rwkv_time_mix(
            cfg, materialize_tree(p["tm"], ps["tm"]), h, state, sx_tm,
            out_state)
    x = x + out
    h = rms_norm(x, materialize(p["ln2"], ps["ln2"]), cfg.norm_eps)
    if ssm.rwkv_tp(cfg, mesh) and cfg.d_ff % mesh.shape["model"] == 0:
        out, new_sx_cm = ssm.rwkv_channel_mix_tp(cfg, p["cm"], ps["cm"], h,
                                                 sx_cm, mesh)
    else:
        out, new_sx_cm = ssm.rwkv_channel_mix(
            cfg, materialize_tree(p["cm"], ps["cm"]), h, sx_cm)
    x = x + out
    if ce is not None:
        sx_tm.copy_(new_sx_tm)
        sx_cm.copy_(new_sx_cm)
    return x, ce, None


def _mamba_sharded(cfg, p, ps, h, ce, mesh, cache_batch):
    """The hybrid layer's Mamba branch under a mesh: over this rank's dI /
    tp channels (``ssm.mamba_branch_tp``) where ``ssm.mamba_tp`` says so,
    whole otherwise; the cache's ssm_h holds dI / tp exactly there."""
    from repro_torch.launch.shard_rules import cache_spec
    B, d = h.shape[0], cfg.d_model
    N = cfg.ssm.state_dim
    h_spec = None if ce is None else cache_spec(
        "ssm_h", (1, cache_batch, d, N), mesh, batch=cache_batch)
    tp = ssm.mamba_tp(cfg, mesh, h_spec)
    if ce is None:
        dl = d // mesh.shape["model"] if tp else d
        h_state = torch.zeros((B, dl, N), dtype=torch.float32,
                              device=h.device)
        conv_state = torch.zeros((B, cfg.ssm.conv_dim - 1, d),
                                 dtype=torch.float32, device=h.device)
    else:
        h_state, conv_state = ce["ssm_h"], ce["ssm_conv"]
    if tp:
        out, new_h, new_conv = ssm.mamba_branch_tp(cfg, p, ps, h, h_state,
                                                   conv_state, mesh)
    else:
        out, new_h, new_conv = ssm.mamba_branch(
            cfg, materialize_tree(p, ps), h, h_state, conv_state)
    if ce is not None:
        h_state.copy_(new_h)
        conv_state.copy_(new_conv)
    return out


def ffn_sharded(cfg, p, ps, h):
    """The dense FFN column- then row-parallel over 'model' and an
    all-reduce, where the specs split f over 'model'; whole otherwise."""
    if ps["w_gate"][-1] == ps["w_up"][-1] == ps["w_down"][0] == "model":
        lp = {"w_gate": materialize(p["w_gate"], ps["w_gate"], keep=1),
              "w_up": materialize(p["w_up"], ps["w_up"], keep=1),
              "w_down": materialize(p["w_down"], ps["w_down"], keep=0)}
        return all_reduce(_ffn(cfg, lp, h), "model")
    return _ffn(cfg, materialize_tree(p, ps), h)


def _embed_sharded(table, spec, inputs, mesh):
    """The token lookup: vocab-parallel (each rank's rows, the others
    masked to zero, then an all-reduce over 'model') where the table's
    rows split over 'model'; a lookup in the gathered table otherwise."""
    ids = inputs.long()
    if spec[0] != "model":
        return materialize(table, spec)[ids]
    table = materialize(table, spec, keep=0)
    n = table.shape[0]
    local = ids - mesh.index("model") * n
    mine = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)]
    return all_reduce(torch.where(mine[..., None], x, 0), "model")


def _head_sharded(cfg, params, specs, x):
    """Logits through a vocab-parallel head (the tied table's rows, or
    lm_head's columns, over 'model'), all-gathered over 'model'."""
    name, vdim = ("embed", 0) if cfg.tie_embeddings else ("lm_head", 1)
    w = materialize(params[name], specs[name], keep=vdim)
    logits = x @ (w.T if vdim == 0 else w).to(x.dtype)
    if specs[name][vdim] == "model":
        logits = all_gather(logits, "model", dim=-1)
    return logits


def _apply_layer_sharded(cfg, spec, p, ps, x, ce, pos, block_tables,
                         verify, mesh, q_block, cache_batch):
    if spec.kind == "rwkv":
        if block_tables is not None:
            raise ValueError("an RWKV layer has no paged cache")
        return _rwkv_sharded(cfg, p, ps, x, ce, mesh, cache_batch)
    h = rms_norm(x, materialize(p["ln1"], ps["ln1"]), cfg.norm_eps)
    if cfg.attention_kind == "mla":
        a_out = _mla_sharded(cfg, spec, p["attn"], ps["attn"], h, ce, pos,
                             block_tables, mesh, q_block, cache_batch)
    else:
        a_out = _gqa_sharded(cfg, spec, p["attn"], ps["attn"], h, ce, pos,
                             block_tables, verify, mesh, q_block,
                             cache_batch)
    if spec.kind == "hybrid":
        s_out = _mamba_sharded(cfg, p["mamba"], ps["mamba"], h, ce, mesh,
                               cache_batch)
        x = x + _fuse(cfg, materialize(p["fuse_na"], ps["fuse_na"]),
                      materialize(p["fuse_ns"], ps["fuse_ns"]), a_out, s_out)
    else:
        x = x + a_out
    h = rms_norm(x, materialize(p["ln2"], ps["ln2"]), cfg.norm_eps)
    if spec.moe:
        f_out, aux = moe.moe_ffn(cfg, p["moe"], h, ps["moe"])
    else:
        f_out, aux = ffn_sharded(cfg, p["mlp"], ps["mlp"], h), None
    return x + f_out, ce, aux


def _fuse(cfg, na, ns, a_out, s_out):
    """Hymba's fusion of the attention and Mamba branches."""
    return 0.5 * (rms_norm(a_out, na, cfg.norm_eps)
                  + rms_norm(s_out, ns, cfg.norm_eps))


def _mix_branches(cfg, spec, p, x, h, a_out, ce):
    """The residual after attention: Hymba's hybrid layer fuses the
    attention output with its parallel Mamba branch."""
    if spec.kind != "hybrid":
        return x + a_out
    h_state, conv_state = _hybrid_state(cfg, ce, x.shape[0], x.device)
    s_out, new_h, new_conv = ssm.mamba_branch(cfg, p["mamba"], h,
                                              h_state, conv_state)
    if ce is not None:
        h_state.copy_(new_h)
        conv_state.copy_(new_conv)
    return x + _fuse(cfg, p["fuse_na"], p["fuse_ns"], a_out, s_out)


def apply_layer(cfg, spec, p, x, ce, pos, block_tables=None, verify=False,
                pspecs=None, q_block=512, cache_batch=None):
    """One transformer layer. ce: cache elem dict or None (paged pool
    elems when ``block_tables`` is given). Returns (x, new_cache_elem,
    aux_loss), the cache elem updated in place. ``pspecs``: the layer's
    leaf specs, under an active mesh (``p`` then holds this rank's
    slices; ``cache_batch``: the global batch of the dense cache, whose
    layout ``shard_rules.cache_spec`` gives)."""
    mesh = active_mesh()
    if mesh is not None:
        return _apply_layer_sharded(cfg, spec, p, pspecs, x, ce, pos,
                                    block_tables, verify, mesh, q_block,
                                    cache_batch)
    if spec.kind == "rwkv":
        return (*_rwkv_layer(cfg, p, x, ce), None)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attention_kind == "mla":
        a_out, _ = attn.mla_layer(cfg, spec, p["attn"], h, ce, pos,
                                  block_tables, q_block)
    else:
        a_out, _ = attn.gqa_layer(cfg, spec, p["attn"], h, ce, pos,
                                  block_tables, verify, q_block)
    x = _mix_branches(cfg, spec, p, x, h, a_out, ce)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.moe:
        f_out, aux = moe.moe_ffn(cfg, p["moe"], h)
    else:
        f_out, aux = _ffn(cfg, p["mlp"], h), None
    return x + f_out, ce, aux


def _unstack(tree, n):
    """The ``n`` per-layer trees of a stacked stage element: every leaf
    unbound along its leading ``repeat`` axis (views). Under autograd one
    unbind per leaf gathers the layers' gradients into one stacked
    gradient, where indexing each layer would materialise a zero-filled
    copy of the whole stacked leaf per layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, n) for v in tree]
        return [[p[r] for p in parts] for r in range(n)]
    return tree.unbind(0)


def apply_model(cfg: ModelConfig, params, inputs, cache=None, pos=0, *,
                logits_slice=None, logits_at=None, block_tables=None,
                verify=False, return_aux=False, q_block=512,
                cache_batch=None):
    """inputs: int tokens (B,S), or float embeddings (B,S,d) for the
    configurations whose modality frontend is stubbed. Returns (logits,
    cache), or (logits, cache, aux) with ``return_aux``.

    cache/pos implement chunked (partial) prefill and decode (the cache is
    updated in place and returned); cache=None is training/eval over the
    full sequence. ``block_tables`` (B,maxblk) switches the cache to the
    PAGED layout (shared block pools indexed per sequence); ``verify``
    routes a paged chunk through the speculative verify kernel.
    ``logits_at`` (B,) computes the head only at one per-sequence chunk
    index (exact last-token logits under right-padded bucketed prefill),
    returning (B,1,vocab). ``aux`` is the sum of the MoE layers'
    load-balance losses (float32; 0 without MoE layers), the reference's
    third return value, which training adds to the loss. ``q_block``: the
    query-block size of every layer's plain masked attention (the
    reference's; each block checkpointed under autograd).

    Under a mesh with a dense cache, ``cache_batch`` is the global batch
    the cache was made for (``init_cache``'s ``batch``): with the mesh it
    fixes the cache's layout (``launch/shard_rules.py::cache_spec``), as a
    sharded array carries its own in the reference."""
    mesh = active_mesh()
    if mesh is not None and cache is not None and block_tables is None \
            and cache_batch is None:
        raise ValueError("apply_model: a dense cache under a mesh needs "
                         "cache_batch, the global batch it was made for")
    specs = None
    if mesh is not None:
        from repro_torch.launch.shard_rules import model_specs
        specs = model_specs(cfg, mesh)
    if inputs.is_floating_point():
        x = inputs.to(params["embed"].dtype)
    elif mesh is not None:
        x = _embed_sharded(params["embed"], specs["embed"], inputs, mesh)
    else:
        x = params["embed"][inputs.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=x.device, dtype=torch.int32)
    if block_tables is not None:
        block_tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                       device=x.device)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device) \
        if return_aux else None
    for si, st in enumerate(cfg.stages):
        elems = params["stages"][si]
        lspecs = [None] * len(elems)
        if specs is not None:
            elems = [_whole_repeat(e, sp) for e, sp in
                     zip(elems, specs["stages"][si])]
            lspecs = [_layer_specs(e) for e in specs["stages"][si]]
        layers = [_unstack(e, st.repeat) for e in elems]
        cache_st = cache["stages"][si] if cache is not None else None
        for r in range(st.repeat):
            for ei, spec in enumerate(st.pattern):
                ce = None if cache_st is None else \
                    tree_map(lambda t: t[r], cache_st[ei])
                x, _, aux = apply_layer(cfg, spec, layers[ei][r], x, ce,
                                        pos, block_tables, verify,
                                        lspecs[ei], q_block, cache_batch)
                if return_aux and aux is not None:
                    aux_total = aux_total + aux

    final_norm = params["final_norm"] if mesh is None else \
        materialize(params["final_norm"], specs["final_norm"])
    x = rms_norm(x, final_norm, cfg.norm_eps)
    if logits_at is not None:
        logits_at = torch.as_tensor(logits_at, device=x.device).long()
        x = x[torch.arange(x.shape[0], device=x.device), logits_at][:, None]
    elif logits_slice is not None:
        x = x[:, -logits_slice:, :]
    if mesh is not None:
        logits = _head_sharded(cfg, params, specs, x)
    else:
        head = params["embed"].T if cfg.tie_embeddings else \
            params["lm_head"]
        logits = x @ head.to(x.dtype)
    logits = softcap(logits, cfg.final_logit_softcap)
    if return_aux:
        return logits, cache, aux_total
    return logits, cache
