"""The system under test: the port's engines and Teola, stood up through
the port's own entry points, and the benchmark's spans and records
around them.

``build`` makes the engines with ``repro_torch.core.apps.build_engines``,
puts the configuration's core LLM in as a ``repro_torch.engines.
llm_engine.LLMEngine`` on the weights the benchmark drew, hands the
encoders their weights, passes the dict through ``repro_torch.launch.
serve.make_engines`` with the configuration's serve flags and wraps the
app in ``repro_torch.core.teola.Teola``: the calls the port's serve entry
point makes. ``LLMEngine`` draws its own weights in its constructor and
has no argument to take others, so ``init_params`` is swapped for the
benchmark's tree while the engine is made: a second 53 GiB draw would not
fit beside the first.

``Capture`` wraps the engines' entry points (instance attributes: the
program's code is untouched) to record what the window produced and
how long each decode step took.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from harness import weights


def program_config(conf: dict):
    """The port's ModelConfig named by the configuration file, held equal
    to the file's sizes."""
    from repro_torch.configs.base import get_config
    cfg = get_config(conf["program_config"])
    if "program_reduce" in conf:             # CPU tests only
        cfg = cfg.reduced(**conf["program_reduce"])
    want = {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
            "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.norm_eps}
    if conf["architecture"] == "qwen2_moe":
        mo = cfg.moe
        want.update(num_attention_heads=cfg.num_heads,
                    num_key_value_heads=cfg.num_kv_heads,
                    head_dim=cfg.resolved_head_dim,
                    num_experts=mo.num_experts,
                    num_experts_per_tok=mo.top_k,
                    moe_intermediate_size=mo.d_expert,
                    shared_expert_intermediate_size=mo.d_shared,
                    norm_topk_prob=mo.norm_topk_prob,
                    rope_theta=cfg.rope_theta)
        same = (cfg.qkv_bias and cfg.rope_kind == "neox" and cfg.act ==
                "silu" and cfg.attention_kind == "gqa"
                and cfg.attn_logit_softcap is None
                and cfg.final_logit_softcap is None
                and not cfg.embed_scale and not cfg.tie_embeddings
                and all(sp.moe and sp.kind == "attn" and sp.window is None
                        for st in cfg.stages for sp in st.pattern))
    else:
        want.update(head_size=cfg.ssm.head_dim, lora_rank=cfg.ssm.lora_rank,
                    intermediate_size=cfg.d_ff)
        same = (cfg.ssm.kind == "rwkv6" and not cfg.tie_embeddings
                and all(sp.kind == "rwkv" for st in cfg.stages
                        for sp in st.pattern))
    bad = {k: (conf[k], v) for k, v in want.items() if conf[k] != v}
    if bad or not same:
        raise ValueError(f"{conf['name']}: the port's {cfg.name} differs "
                         f"from the configuration file: {bad or 'layout'}")
    return cfg


def _check_encoder(name, enc_cfg, e):
    have = {"vocab_size": enc_cfg.vocab_size, "hidden_size": enc_cfg.d_model,
            "num_attention_heads": enc_cfg.num_heads,
            "intermediate_size": enc_cfg.d_ff,
            "num_hidden_layers": enc_cfg.num_layers,
            "max_len": enc_cfg.max_len, "out_dim": enc_cfg.out_dim,
            "pooling": enc_cfg.pooling, "rms_norm_eps": enc_cfg.norm_eps}
    bad = {k: (e[k], v) for k, v in have.items() if e[k] != v}
    if bad:
        raise ValueError(f"the port's {name} encoder differs from the "
                         f"configuration file: {bad}")


@contextlib.contextmanager
def _weights_for(module, params):
    orig = module.init_params
    module.init_params = lambda *a, **k: params
    try:
        yield
    finally:
        module.init_params = orig


def replicas(engine) -> list:
    """The engine instances behind an engines-dict value."""
    from repro_torch.core.engine_pool import replicas_of
    return replicas_of(engine)


def build(conf: dict, mix: dict, seed: int, device, dtype=torch.float32):
    """(teola, engines, params): the cell's system, not yet warm."""
    from repro_torch.core.apps import ALL_APPS, build_engines
    from repro_torch.core.teola import Teola
    from repro_torch.engines import llm_engine
    from repro_torch.launch import serve as serve_cli
    cfg = program_config(conf)
    sv = conf["serving"]
    ap = serve_cli.build_parser()
    args = ap.parse_args(["--app", mix["app"], "--scheme", "Teola",
                          *sv["flags"]])
    serve_cli.validate_args(ap, args)
    if args.continuous_batching or args.chunked_prefill:
        raise ValueError(f"{conf['name']}: Capture records the "
                         f"run-to-completion path only, not the continuous "
                         f"loop that {sv['flags']} turn on")
    opts = dict(paged_kv=args.paged_kv, chunked_prefill=args.chunked_prefill,
                prefill_chunk=args.prefill_chunk,
                token_budget=args.token_budget, prefix_cache=args.prefix_cache)
    engines = build_engines(device=device, llm_max_batch=sv["max_batch"],
                            **opts)
    params = weights.decoder_params(conf, seed, device, dtype)
    with _weights_for(llm_engine, params):
        engines["core_llm"] = llm_engine.LLMEngine(
            "core_llm", cfg, max_len=sv["max_len"],
            max_batch=sv["max_batch"], dtype=dtype, paged=args.paged_kv,
            device=device, **{k: v for k, v in opts.items()
                              if k != "paged_kv"})
    enc = {}
    for stream, name in ((1, "embedding"), (2, "rerank")):
        _check_encoder(name, engines[name].cfg, conf["encoders"][name])
        enc[name] = weights.encoder_params(conf["encoders"][name], seed,
                                           stream, device)
        engines[name].params = enc[name]
    engines = serve_cli.make_engines(args, base=engines)
    teola = Teola(ALL_APPS[mix["app"]](engines), engines, policy="topo",
                  streaming=args.streaming,
                  continuous_batching=args.continuous_batching)
    return teola, engines, params, enc


def warm_up(teola, core, query: dict, max_batch: int, text: str):
    """One query of the cell's app, then one batch of ``max_batch``
    sequences straight through the core LLM (prefill of ``text``, 8
    decode steps) on the path the window uses. Returns the seconds of
    each."""
    t0 = time.time()
    _, ctx = teola.query({"question": query["question"],
                          "docs": query["docs"]}, timeout=600)
    if ctx.error is not None:
        raise ctx.error
    t1 = time.time()
    sids = [f"warm-up:{i}" for i in range(max_batch)]
    core.op_prefill([{"sid": s, "text": text} for s in sids])
    core.op_decode([{"sid": s, "max_new": 8} for s in sids])
    for s in sids:
        core.release(s)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return t1 - t0, time.time() - t1


class Capture:
    """Records of the window, taken while ``on``: every core-LLM
    generation by query (the context its prefills wrote, the served
    tokens), each decode step's host span, and the encoders', vector
    store's and reranker's inputs and answers."""

    def __init__(self, engines):
        self.on = False
        self.lock = threading.Lock()
        self.gens, self._ctx, self.spans = {}, {}, []
        self.rec = {"embedded": {}, "vec_text": {}, "collections": {},
                    "searches": [], "reranks": []}
        self._core(engines["core_llm"])
        self._encoders(engines["embedding"], engines["rerank"])
        self._vectordb(engines["vectordb"])

    def _done(self, sid, ctx, first, ids):
        with self.lock:
            self._ctx[sid] = ctx + [first] + list(ids[:-1])
            if self.on:
                self.gens.setdefault(sid.split(":")[0], []).append(
                    {"ctx": ctx, "served": [first] + [int(i) for i in ids]})

    def _span(self, t0, tokens, steps):
        """A decode span: (start, end, tokens decoded, steps)."""
        if self.on:
            self.spans.append((t0, time.time(), tokens, steps))

    def _core(self, core):
        prep, op_decode, decode_batch = (core._prepare_prefill_task,
                                         core.op_decode, core.decode_batch)
        local = threading.local()

        def _prepare_prefill_task(t):
            fresh = t["sid"] not in core.states
            st, out, ptoks = prep(t)
            with self.lock:
                prev = [] if fresh else self._ctx.get(t["sid"], [])
                self._ctx[t["sid"]] = prev + list(ptoks) + list(out)
            return st, out, ptoks

        def _fed(sid):
            with self.lock:
                return (list(self._ctx.get(sid, [])),
                        int(core.states[sid].last_token))

        def _decode_batch(items, on_chunk=None):
            t0 = time.time()
            local.outs = decode_batch(items, on_chunk)
            self._span(t0, sum(n for _, n in items),
                       max(n for _, n in items))
            return local.outs

        def _op_decode(task_batch, on_chunk=None):
            fed = [(t["sid"], *_fed(t["sid"])) for t in task_batch]
            texts = op_decode(task_batch, on_chunk)
            for (sid, ctx, first), ids in zip(fed, local.outs):
                self._done(sid, ctx, first, ids)
            return texts

        core._prepare_prefill_task = _prepare_prefill_task
        core.decode_batch = _decode_batch
        core.op_decode = _op_decode

    def _encoders(self, emb, rr):
        op_embed, op_rerank = emb.op_embed, rr.op_rerank
        rec = self.rec

        def _op_embed(tasks):
            res = op_embed(tasks)
            if self.on:
                with self.lock:
                    for t, r in zip(tasks, res):
                        for text, v in zip(t["texts"], r):
                            v = np.array(v, np.float32)
                            rec["embedded"].setdefault(text, []).append(v)
                            rec["vec_text"][v.tobytes()] = text
            return res

        def _op_rerank(tasks):
            res = op_rerank(tasks)
            if self.on:
                with self.lock:
                    for t, r in zip(tasks, res):
                        if t["candidates"]:
                            rec["reranks"].append({
                                "question": t["question"],
                                "candidates": [c["text"]
                                               for c in t["candidates"]],
                                "top_k": t.get("top_k", 3),
                                "chosen": [(c["text"], c["rerank_score"])
                                           for c in r]})
            return res
        emb.op_embed = _op_embed
        rr.op_rerank = _op_rerank

    def _vectordb(self, vdb):
        op_ingest, op_search = vdb.op_ingest, vdb.op_search
        rec = self.rec

        def _op_ingest(tasks):
            with self.lock:
                for t in tasks:
                    rec["collections"].setdefault(t["collection"], []).extend(
                        m["text"] for m in t["meta"])
            return op_ingest(tasks)

        def _op_search(tasks):
            res = op_search(tasks)
            if self.on:
                with self.lock:
                    for t, r in zip(tasks, res):
                        rec["searches"].append({
                            "collection": t["collection"],
                            "qkey": np.asarray(t["query_vec"],
                                               np.float32).tobytes(),
                            "top_k": t.get("top_k", 3),
                            "hits": [(h["text"], h["score"]) for h in r]})
            return res
        vdb.op_ingest = _op_ingest
        vdb.op_search = _op_search


class KernelCalls:
    """While ``on``, the shapes and positions of every hand-written kernel
    call the model makes: the model modules' references to the kernel
    wrappers are wrapped (as the port's chip_smoke.py does for K6). The
    position tensors are kept, not read, so recording adds no host sync;
    ``bounds`` reads them after the slice."""

    NAMES = ("flash_prefill", "decode_attention", "paged_decode_attention",
             "verify_attention", "chunk_prefill_attention")

    def __init__(self):
        from repro_torch.models import attention
        self.on = False
        self.calls = []
        self._orig = []
        for name in self.NAMES:
            self._wrap(attention, name)

    def _wrap(self, mod, name):
        orig = getattr(mod, name)
        self._orig.append((mod, name, orig))

        def traced(*args, **kw):
            if self.on:
                self.calls.append(self._shape(name, args, kw))
            return orig(*args, **kw)
        setattr(mod, name, traced)

    @staticmethod
    def _shape(name, a, kw):
        q, kv = a[0], a[1]
        row = kv.shape[-2] * kv.shape[-1] * kv.element_size() * 2
        pos = {"flash_prefill": kw.get("prefix_len", 0),
               "decode_attention": a[3] if len(a) > 3 else kw.get("length")
               }.get(name, a[4] if len(a) > 4 else None)
        return name, tuple(q.shape), q.element_size(), (row, kv.shape[1]), \
            pos

    def close(self):
        for mod, name, orig in self._orig:
            setattr(mod, name, orig)
        self._orig = []

    def bounds(self) -> dict:
        """{wrapper name: [(nbytes, flops), ...]} of the recorded calls,
        by the frozen work functions."""
        from harness import work
        out = {}
        for name, shape, size, kv, pos in self.calls:
            row, slots = kv
            pos = pos.tolist() if torch.is_tensor(pos) else \
                [int(pos)] * shape[0]
            if name == "flash_prefill":
                w = work.prefill_work(shape, size, pos, row, slots)
            elif name == "decode_attention":
                w = work.decode_work(shape, size, pos, row, slots)
            else:
                sq = 1 if len(shape) == 3 else shape[1]
                first = pos if name == "chunk_prefill_attention" else \
                    [p - sq for p in pos]
                w = work.paged_work(shape, size,
                                    [list(range(f, f + sq))
                                     for f in first], row)
            out.setdefault(name, []).append(w)
        self.calls = []
        return out
