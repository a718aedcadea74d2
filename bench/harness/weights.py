"""Weights made from ``--seed``, on the device, one call per stacked leaf,
in the nested layout the port's engines take (``params``): a decoder's
``{"embed", "final_norm", "lm_head", "stages": [[layer]]}`` with every
layer leaf stacked over the layers, and an encoder's ``{"embed",
"pos_embed", "final_norm", "head", "layers": [...]}``.

The benchmark hands the same tensors to the program and to the
reference. Products are drawn N(0, 1/fan_in); norm scales (applied as
1 + scale) N(0, 0.1^2); biases N(0, 0.02^2); RWKV-6's token-shift mixes
U(0, 1), its decay base U(-6, -1) (per-channel decays from 0.69 to
0.998), its bonus N(0, 0.5^2) and its group-norm scale 1 + N(0, 0.1^2).
"""
from __future__ import annotations

import torch

# leaves kept in float32 whatever the serving dtype, as the port's
# models/common.py::FP32_LEAVES has them
FP32_LEAVES = frozenset({"router", "dt_bias", "A_log", "D", "w_base", "u",
                         "gn_scale"})


def _decoder_spec(c: dict) -> list:
    """(path, shape, kind, arg) of every leaf, in draw order."""
    d, L, V = c["hidden_size"], c["num_hidden_layers"], c["vocab_size"]
    spec = [(("embed",), (V, d), "normal", 0.02),
            (("final_norm",), (d,), "normal", 0.1),
            (("lm_head",), (d, V), "normal", d ** -0.5)]
    lay = ("stages", 0, 0)
    spec += [(lay + ("ln1",), (L, d), "normal", 0.1),
             (lay + ("ln2",), (L, d), "normal", 0.1)]
    if c["architecture"] == "qwen2_moe":
        H, K, hd = c["num_attention_heads"], c["num_key_value_heads"], \
            c["head_dim"]
        E, f, fs = c["num_experts"], c["moe_intermediate_size"], \
            c["shared_expert_intermediate_size"]
        a, m = lay + ("attn",), lay + ("moe",)
        spec += [(a + ("wq",), (L, d, H * hd), "normal", d ** -0.5),
                 (a + ("wk",), (L, d, K * hd), "normal", d ** -0.5),
                 (a + ("wv",), (L, d, K * hd), "normal", d ** -0.5),
                 (a + ("wo",), (L, H * hd, d), "normal", (H * hd) ** -0.5),
                 (a + ("bq",), (L, H * hd), "normal", 0.02),
                 (a + ("bk",), (L, K * hd), "normal", 0.02),
                 (a + ("bv",), (L, K * hd), "normal", 0.02),
                 (m + ("router",), (L, d, E), "normal", d ** -0.5),
                 (m + ("w_gate",), (L, E, d, f), "normal", d ** -0.5),
                 (m + ("w_up",), (L, E, d, f), "normal", d ** -0.5),
                 (m + ("w_down",), (L, E, f, d), "normal", f ** -0.5),
                 (m + ("shared", "w_gate"), (L, d, fs), "normal", d ** -0.5),
                 (m + ("shared", "w_up"), (L, d, fs), "normal", d ** -0.5),
                 (m + ("shared", "w_down"), (L, fs, d), "normal",
                  fs ** -0.5)]
    elif c["architecture"] == "rwkv6":
        hd, r, f = c["head_size"], c["lora_rank"], c["intermediate_size"]
        H = d // hd
        tm, cm = lay + ("tm",), lay + ("cm",)
        spec += [(tm + ("mix_base",), (L, 5, d), "uniform", (0.0, 1.0)),
                 (tm + ("mix_w1",), (L, d, 5 * r), "normal", d ** -0.5),
                 (tm + ("mix_w2",), (L, 5, r, d), "normal", 0.1 * r ** -0.5)]
        spec += [(tm + (n,), (L, d, d), "normal", d ** -0.5)
                 for n in ("wr", "wk", "wv", "wg", "wo")]
        spec += [(tm + ("w_base",), (L, d), "uniform", (-6.0, -1.0)),
                 (tm + ("w_w1",), (L, d, r), "normal", d ** -0.5),
                 (tm + ("w_w2",), (L, r, d), "normal", 0.1 * r ** -0.5),
                 (tm + ("u",), (L, H, hd), "normal", 0.5),
                 (tm + ("gn_scale",), (L, H, hd), "one_plus", 0.1),
                 (cm + ("mix_k",), (L, d), "uniform", (0.0, 1.0)),
                 (cm + ("mix_r",), (L, d), "uniform", (0.0, 1.0)),
                 (cm + ("wk",), (L, d, f), "normal", d ** -0.5),
                 (cm + ("wv",), (L, f, d), "normal", f ** -0.5),
                 (cm + ("wr",), (L, d, d), "normal", d ** -0.5)]
    else:
        raise ValueError(f"no weights for architecture "
                         f"{c['architecture']!r}")
    return spec


def _encoder_spec(e: dict) -> list:
    d, f = e["hidden_size"], e["intermediate_size"]
    spec = [(("embed",), (e["vocab_size"], d), "normal", 0.02),
            (("pos_embed",), (e["max_len"], d), "normal", 0.02),
            (("final_norm",), (d,), "normal", 0.1),
            (("head",), (d, e["out_dim"]), "normal", d ** -0.5)]
    for i in range(e["num_hidden_layers"]):
        lay = ("layers", i)
        spec += [(lay + ("ln1",), (d,), "normal", 0.1),
                 (lay + ("ln2",), (d,), "normal", 0.1)]
        spec += [(lay + (n,), (d, d), "normal", d ** -0.5)
                 for n in ("wq", "wk", "wv", "wo")]
        spec += [(lay + ("w1",), (d, f), "normal", d ** -0.5),
                 (lay + ("w2",), (f, d), "normal", f ** -0.5)]
    return spec


def _draw(gen, shape, kind, arg, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if kind == "uniform":
        return t.uniform_(arg[0], arg[1], generator=gen)
    t.normal_(0.0, arg, generator=gen)
    return t.add_(1.0) if kind == "one_plus" else t


def _put(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        default = [] if isinstance(nxt, int) else {}
        if isinstance(key, int):
            while len(node) <= key:
                node.append(default)
                default = [] if isinstance(nxt, int) else {}
            node = node[key]
        else:
            node = node.setdefault(key, default)
    node[path[-1]] = value


def _build(spec, seed: int, stream: int, device, dtype):
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + stream) % 2 ** 63)
    tree = {}
    for path, shape, kind, arg in spec:
        t = _draw(gen, shape, kind, arg, device)
        if dtype != torch.float32 and path[-1] not in FP32_LEAVES:
            t = t.to(dtype)
        _put(tree, path, t)
    return tree


def decoder_params(conf: dict, seed: int, device, dtype=torch.float32):
    """The core LLM's weights: every leaf drawn in float32 on ``device``
    from the seed, then cast to ``dtype`` (but FP32_LEAVES), so that a
    float32 and a bfloat16 draw of one seed hold the same values."""
    return _build(_decoder_spec(conf), seed, 0, device, dtype)


def encoder_params(enc: dict, seed: int, stream: int, device,
                   dtype=torch.float32):
    """An encoder's weights (``stream`` 1: the embedder, 2: the
    reranker)."""
    return _build(_encoder_spec(enc), seed, stream, device, dtype)
