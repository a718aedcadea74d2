"""The plain reference: each model of a cell written out in plain PyTorch
over a whole sequence, with no cache, no batching, no bucket and no
kernel, in float32 with TF32 off. It reads the weights the benchmark made
(``harness/weights.py``'s layout) and nothing the program made.

- ``qwen2_moe``: RMSNorm (gain 1 + w), GQA with q/k/v biases and
  half-split (NeoX) RoPE, causal softmax attention, then the MoE FFN:
  softmax router over all experts, top-k, the gates not renormalised
  (``norm_topk_prob`` false), SiLU-gated experts, plus one SiLU-gated
  shared expert; the LM head. The configuration states a bfloat16 KV
  cache, so K (after RoPE) and V are rounded to bfloat16 before they are
  read. Departure from the published model, as the port defines it: no
  sigmoid gate on the shared expert.
- ``rwkv6``: RWKV-6 "Finch": token shift with a data-dependent lerp (a
  LoRA over five mixes), the data-dependent decay w = exp(-exp(.)),
  the WKV recurrence y_t = r_t (S + diag(u) k_t v_t^T), S <- diag(w_t) S +
  k_t v_t^T from a zero state, a per-head group norm, a SiLU gate; the
  channel mix sigmoid(r) * (relu(k)^2 W_v). As the port defines it: no
  ln0 on the embeddings, no group-norm bias, RMSNorm for the layer
  norms.
- the encoders: a bidirectional transformer (RMSNorm, softmax attention,
  tanh-GELU MLP, learned positions); the embedder mean-pools the tokens
  and L2-normalises the projection, the reranker scores the first token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + w)


def _rope(x, theta):
    """Half-split rotary embedding of x (S, heads, hd) at positions 0..S-1."""
    S, _, hd = x.shape
    inv = theta ** (-torch.arange(0, hd, 2, device=x.device,
                                  dtype=torch.float32) / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(tree, i):
    """Layer i's leaves of a stacked layer tree, in float32."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i].float()


def _causal_attention(q, k, v):
    """q (S, H, hd), k and v (S, K, hd) -> (S, H * hd)."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("shd,thd->hst", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hst,thd->shd", p, v).reshape(S, H * hd)


def _qwen_layer(c, p, x, kv_dtype):
    eps = c["rms_norm_eps"]
    H, K, hd = c["num_attention_heads"], c["num_key_value_heads"], \
        c["head_dim"]
    S = x.shape[0]
    a = p["attn"]
    h = _rms(x, p["ln1"], eps)
    q = (h @ a["wq"] + a["bq"]).view(S, H, hd)
    k = (h @ a["wk"] + a["bk"]).view(S, K, hd)
    v = (h @ a["wv"] + a["bv"]).view(S, K, hd)
    q, k = _rope(q, c["rope_theta"]), _rope(k, c["rope_theta"])
    k, v = k.to(kv_dtype).float(), v.to(kv_dtype).float()
    x = x + _causal_attention(q, k, v) @ a["wo"]
    h = _rms(x, p["ln2"], eps)
    m = p["moe"]
    probs = torch.softmax(h @ m["router"], dim=-1)
    gates, idx = probs.topk(c["num_experts_per_tok"], dim=-1)
    if c["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in idx.unique().tolist():
        rows, slot = (idx == e).nonzero(as_tuple=True)
        y = F.silu(h[rows] @ m["w_gate"][e]) * (h[rows] @ m["w_up"][e])
        out.index_add_(0, rows, (y @ m["w_down"][e]) * gates[rows, slot,
                                                             None])
    s = m["shared"]
    out = out + (F.silu(h @ s["w_gate"]) * (h @ s["w_up"])) @ s["w_down"]
    return x + out


def _shift(x):
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def _rwkv_layer(c, p, x):
    eps = c["rms_norm_eps"]
    hd = c["head_size"]
    S, d = x.shape
    H = d // hd
    tm, cm = p["tm"], p["cm"]
    h = _rms(x, p["ln1"], eps)
    dx = _shift(h) - h
    t = torch.tanh((h + dx * tm["mix_base"][0]) @ tm["mix_w1"]).view(S, 5, -1)
    mix = tm["mix_base"] + torch.einsum("sfl,fld->sfd", t, tm["mix_w2"])
    x_w, x_k, x_v, x_r, x_g = (h[:, None] + dx[:, None] * mix).unbind(1)
    r = (x_r @ tm["wr"]).view(S, H, hd)
    k = (x_k @ tm["wk"]).view(S, H, hd)
    v = (x_v @ tm["wv"]).view(S, H, hd)
    g = F.silu(x_g @ tm["wg"])
    w = torch.exp(-torch.exp(tm["w_base"] + torch.tanh(x_w @ tm["w_w1"])
                             @ tm["w_w2"])).view(S, H, hd)
    state = torch.zeros(H, hd, hd, device=x.device)
    ys = []
    for i in range(S):
        kv = k[i, :, :, None] * v[i, :, None, :]
        ys.append(torch.einsum("hk,hkv->hv", r[i],
                               state + tm["u"][:, :, None] * kv))
        state = w[i, :, :, None] * state + kv
    y = torch.stack(ys)                                     # (S, H, hd)
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).pow(2).mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 64e-5) * tm["gn_scale"]
    x = x + (y.reshape(S, d) * g) @ tm["wo"]
    h = _rms(x, p["ln2"], eps)
    dx = _shift(h) - h
    kk = torch.relu((h + dx * cm["mix_k"]) @ cm["wk"]).square()
    return x + torch.sigmoid((h + dx * cm["mix_r"]) @ cm["wr"]) * \
        (kk @ cm["wv"])


def decoder_logits(conf: dict, params, tokens, kv_dtype=torch.bfloat16):
    """Logits (S, vocab) of the token sequence ``tokens`` (list of ids),
    each position seeing the tokens before it."""
    dev = params["embed"].device
    ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    with torch.no_grad():
        x = params["embed"][ids].float()
        layers = params["stages"][0][0]
        for i in range(conf["num_hidden_layers"]):
            p = _layer(layers, i)
            if conf["architecture"] == "qwen2_moe":
                x = _qwen_layer(conf, p, x, kv_dtype)
            else:
                x = _rwkv_layer(conf, p, x)
        x = _rms(x, params["final_norm"].float(), conf["rms_norm_eps"])
        return x @ params["lm_head"].float()


def encode(enc: dict, params, tokens, dtype=torch.float32) -> torch.Tensor:
    """One text's token ids (at most the encoder's 64-token input) ->
    the embedder's unit vector (out_dim,) or the reranker's score (),
    computed in ``dtype`` and returned in float32."""
    dev = params["embed"].device
    ids = torch.as_tensor(tokens[:enc["max_tokens"]], dtype=torch.long,
                          device=dev)
    eps, heads = enc["rms_norm_eps"], enc["num_attention_heads"]
    f = {k: v.to(dtype) for k, v in params.items() if k != "layers"}
    with torch.no_grad():
        S = ids.shape[0]
        x = f["embed"][ids] + f["pos_embed"][:S]
        d = x.shape[-1]
        hd = d // heads
        for lp in params["layers"]:
            lp = {k: v.to(dtype) for k, v in lp.items()}
            h = _rms(x, lp["ln1"], eps)
            q, k, v = [(h @ lp[n]).view(S, heads, hd)
                       for n in ("wq", "wk", "wv")]
            s = torch.einsum("shd,thd->hst", q, k) / math.sqrt(hd)
            o = torch.einsum("hst,thd->shd", torch.softmax(s, -1), v)
            x = x + o.reshape(S, d) @ lp["wo"]
            h = _rms(x, lp["ln2"], eps)
            x = x + F.gelu(h @ lp["w1"], approximate="tanh") @ lp["w2"]
        x = _rms(x, f["final_norm"], eps)
        if enc["pooling"] == "mean":
            e = x.mean(0) @ f["head"]
            return (e / (e.norm() + 1e-6)).float()
        return (x[0] @ f["head"]).squeeze(-1).float()
