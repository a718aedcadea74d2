#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. toolchain: the card (nvidia-smi), torch / CUDA versions, nvcc, triton.
  2. build: nvcc compiles every kernel source, all at once.
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the main path's shapes (TinyLlama-1.1B heads), then timed
     beside its plain version and one library call.
  4. model: TinyLlama-1.1B at full width cut to 2 layers (random weights
     from a seeded torch.Generator): prefill, Pass-3 partial prefill and
     decode on the card through the kernels, against the same code on the
     CPU.
  5. serve (the main path): naive-RAG under Teola with the full 22-layer
     TinyLlama-1.1B as the core LLM; 1 warm-up query, then 4 together.

Before the last line it prints a JSON line of per-kernel numbers and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Without a CUDA card, or without the repository's sources beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.bridge import tree_to  # noqa: E402
from repro_torch.configs.base import Stage, get_config  # noqa: E402
from repro_torch.core.apps import build_engines, naive_rag  # noqa: E402
from repro_torch.core.teola import Teola  # noqa: E402
from repro_torch.engines.llm_engine import LLMEngine  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_prefill import (flash_prefill,  # noqa: E402
                                               flash_prefill_plain)
from repro_torch.models.transformer import apply_model, init_params  # noqa: E402
from repro_torch.serving import kv_cache as kvc  # noqa: E402
from repro_torch.training.data import doc_corpus  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# kernel vs plain version, on the same inputs (fp32 accumulation in both;
# bf16 outputs are compared at bf16 resolution)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# card vs CPU logits of the 2-layer model: K/V are stored in bf16, and a
# projection that differs in its last fp32 bit between the card's and the
# CPU's matmuls can round to a neighbouring bf16 value
MODEL_TOL = 1e-2
H, K, HD, T = 32, 4, 64, 512          # TinyLlama-1.1B attention, max_len
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# phase 1-2

def phase_toolchain(card: str):
    print(f"[toolchain] card: {card}")
    print(f"[toolchain] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    nvcc = build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"[toolchain] nvcc {nvcc}: {ver[-1]}")
    try:
        import triton
        print(f"[toolchain] triton {triton.__version__} imports")
    except ImportError as e:
        print(f"[toolchain] triton does not import ({e})")


def phase_build():
    t0 = time.time()
    log = build.build_all()
    print(f"[build] {len(log)} kernel libraries in {time.time() - t0:.1f} s "
          f"(nvcc in parallel)")
    for name, rec in log.items():
        print(f"[build] {name}: {rec['seconds']:.1f} s")
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, timed

def _kv(B, rs, dev):
    return [torch.from_numpy(rs.standard_normal((B, T, K, HD)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2)]


def _prefill_case(B, Sq, prefix, dev, window=None, cap=None,
                  qdt=torch.float32):
    rs = np.random.RandomState(B * 1000 + Sq)
    q = torch.from_numpy(rs.standard_normal((B, Sq, H, HD)).astype(
        np.float32)).to(dev, qdt)
    k, v = _kv(B, rs, dev)
    pre = torch.tensor(prefix, dtype=torch.int32, device=dev)
    kw = dict(prefix_len=pre, window=window, cap=cap)
    return (q, k, v, kw)


def _decode_case(B, length, dev, window=None, cap=None, qdt=torch.float32):
    rs = np.random.RandomState(B * 7 + 1)
    q = torch.from_numpy(rs.standard_normal((B, H, HD)).astype(
        np.float32)).to(dev, qdt)
    k, v = _kv(B, rs, dev)
    ln = torch.tensor(length, dtype=torch.int32, device=dev)
    return (q, k, v, ln, dict(window=window, cap=cap))


def _prefill_work(q, prefix):
    B, Sq = q.shape[:2]
    pre = prefix.tolist()
    kv_rows = sum(min(T, p + Sq) for p in pre)
    nbytes = (q.numel() * q.element_size() * 2           # q in, o out
              + kv_rows * K * HD * 2 * 2)                 # bf16 k and v
    keys = sum(p * Sq + Sq * (Sq + 1) // 2 for p in pre)  # causal pairs
    flops = 4 * HD * H * keys
    return nbytes, flops


def _decode_work(q, length):
    kv_rows = sum(min(T, n) for n in length.tolist())
    nbytes = q.numel() * q.element_size() * 2 + kv_rows * K * HD * 2 * 2
    flops = 4 * HD * H * kv_rows
    return nbytes, flops


def _bound(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _sdpa_prefill(q, k, v, prefix):
    """One library call computing K1's function (timed only, never used
    by the port): SDPA with the equivalent boolean mask."""
    B, Sq = q.shape[:2]
    qh = q.transpose(1, 2)
    kh = k.float().transpose(1, 2).contiguous()
    vh = v.float().transpose(1, 2).contiguous()
    q_pos = prefix[:, None].long() + torch.arange(Sq, device=q.device)
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= q_pos[:, :, None])[:, None]
    return _sdpa(qh, kh, vh, mask)


def _sdpa(qh, kh, vh, mask):
    """SDPA call over grouped heads: ``enable_gqa`` where this torch has
    it, else K/V heads expanded before the timed call."""
    try:
        F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                       enable_gqa=True)
    except TypeError:
        G = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(G, dim=1)
        vh = vh.repeat_interleave(G, dim=1)
        return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=mask)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  enable_gqa=True)


def _sdpa_decode(q, k, v, length):
    qh = q[:, :, None]
    kh = k.float().transpose(1, 2).contiguous()
    vh = v.float().transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=q.device)[None, :]
            < length[:, None].long())[:, None, None]
    return _sdpa(qh, kh, vh, mask)


def phase_kernels(dev) -> dict:
    """Returns {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms}} at the representative main-path shape."""
    res = {"flash_prefill": {"max_abs_err": 0.0},
           "decode_attention": {"max_abs_err": 0.0}}

    def check(name, got, want, qdt, label):
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[qdt]
        print(f"[kernels] {name} {label}: max_abs_err {err:.3e} "
              f"(tolerance {tol:g})")
        if not (err <= tol):
            raise AssertionError(f"{name} {label}: {err} > {tol}")
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    cases = []
    for B in (1, 4):
        for Sq in (64, 256):
            prefix = [0, 37, 100, 200][:B]
            cases.append((B, Sq, prefix, None, None, torch.float32))
    cases.append((4, 256, [0, 37, 100, 200], 100, 50.0, torch.float32))
    cases.append((4, 128, [0, 37, 100, 200], None, None, torch.bfloat16))
    for B, Sq, prefix, window, cap, qdt in cases:
        q, k, v, kw = _prefill_case(B, Sq, prefix, dev, window, cap, qdt)
        got = flash_prefill(q, k, v, **kw)
        torch.cuda.synchronize()
        check("flash_prefill", got, flash_prefill_plain(q, k, v, **kw), qdt,
              f"B={B} Sq={Sq} prefix={prefix} window={window} cap={cap} "
              f"q={str(qdt)[6:]}")
    dcases = [(1, [300], None, None, torch.float32),
              (4, [1, 130, 300, 512], None, None, torch.float32),
              (4, [1, 130, 300, 512], 64, 50.0, torch.float32),
              (4, [1, 130, 300, 512], None, None, torch.bfloat16)]
    for B, length, window, cap, qdt in dcases:
        q, k, v, ln, kw = _decode_case(B, length, dev, window, cap, qdt)
        got = decode_attention(q, k, v, ln, **kw)
        torch.cuda.synchronize()
        check("decode_attention", got, decode_attention_plain(q, k, v, ln,
                                                              **kw),
              qdt, f"B={B} length={length} window={window} cap={cap} "
              f"q={str(qdt)[6:]}")

    # timings at the representative main-path shapes (batch bucket 4)
    for B, Sq in ((1, 64), (4, 64), (4, 256)):
        prefix = [0, 37, 100, 200][:B]
        q, k, v, kw = _prefill_case(B, Sq, prefix, dev)
        ms = cuda_ms(lambda: flash_prefill(q, k, v, **kw))
        plain = cuda_ms(lambda: flash_prefill_plain(q, k, v, **kw))
        lib = cuda_ms(_sdpa_prefill(q, k, v, kw["prefix_len"]))
        nbytes, flops = _prefill_work(q, kw["prefix_len"])
        bound, by = _bound(nbytes, flops)
        print(f"[kernels] flash_prefill B={B} Sq={Sq} T={T} prefix={prefix}"
              f": kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} "
              f"ms, bound {bound:.4f} ms ({by})")
        res["flash_prefill"].update(ms=ms, plain_ms=plain, bound_ms=bound,
                                    bound_by=by, library_ms=lib)
    for B, length in ((1, [300]), (4, [1, 130, 300, 512])):
        q, k, v, ln, kw = _decode_case(B, length, dev)
        ms = cuda_ms(lambda: decode_attention(q, k, v, ln))
        plain = cuda_ms(lambda: decode_attention_plain(q, k, v, ln))
        lib = cuda_ms(_sdpa_decode(q, k, v, ln))
        nbytes, flops = _decode_work(q, ln)
        bound, by = _bound(nbytes, flops)
        print(f"[kernels] decode_attention B={B} T={T} length={length}: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} "
              f"ms, bound {bound:.4f} ms ({by})")
        res["decode_attention"].update(ms=ms, plain_ms=plain, bound_ms=bound,
                                       bound_by=by, library_ms=lib)
    return res


# ---------------------------------------------------------------------------
# phase 4: 2-layer TinyLlama-1.1B, card against CPU

def two_layer_tinyllama():
    cfg = get_config("tinyllama-1.1b")
    st = cfg.stages[0]
    return dataclasses.replace(cfg, name="tinyllama-1.1b-2l",
                               stages=(Stage(pattern=st.pattern, repeat=2),))


def run_model(cfg, params, dev, toks):
    """Prefill 100 tokens, partial-prefill 40 more on the same cache, then
    8 decode steps, all fed fixed tokens (so both devices see the same
    inputs). Returns the logits of every call, on the CPU."""
    cache = kvc.init_cache(cfg, 1, T, device=dev)
    outs = []
    with torch.inference_mode():
        for lo, hi in ((0, 100), (100, 140)):
            x = torch.as_tensor(toks[None, lo:hi], device=dev)
            logits, cache = apply_model(cfg, params, x, cache, lo)
            outs.append(logits.float().cpu())
        for i in range(8):
            x = torch.as_tensor(toks[None, 140 + i:141 + i], device=dev)
            logits, cache = apply_model(cfg, params, x, cache, 140 + i)
            outs.append(logits.float().cpu())
    return outs


def phase_model(dev):
    cfg = two_layer_tinyllama()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    params_cpu = init_params(cfg, gen, torch.float32, "cpu")
    params_dev = tree_to(params_cpu, dev)
    toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size, 148)
    n0 = (flash_prefill.launches, decode_attention.launches)
    got = run_model(cfg, params_dev, dev, toks)
    torch.cuda.synchronize()
    if (flash_prefill.launches - n0[0], decode_attention.launches - n0[1]) \
            != (2 * 2, 8 * 2):
        raise AssertionError("model phase did not run through the kernels")
    want = run_model(cfg, params_cpu, "cpu", toks)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    scale = max(w.abs().max().item() for w in want)
    finite = all(torch.isfinite(g).all().item() for g in got)
    print(f"[model] {cfg.name} (d={cfg.d_model}, H={cfg.num_heads}, "
          f"K={cfg.num_kv_heads}, 2 layers): card vs CPU max |dlogits| "
          f"{err:.3e} over |logits| <= {scale:.3f} (tolerance {MODEL_TOL:g})")
    if not finite or not (err <= MODEL_TOL):
        raise AssertionError(f"model phase: err {err}, finite {finite}")


# ---------------------------------------------------------------------------
# phase 5: the main path

QUESTIONS = ["what is fact 3 about optics", "what is fact 7 about finance",
             "what is fact 12 about optics", "what is fact 30 about finance"]


def _busy(engines) -> dict:
    return {name: e.stats["busy_s"] for name, e in engines.items()
            if "busy_s" in getattr(e, "stats", {})}


def _profiled_query(teola, docs, card: str):
    """One more query under torch.profiler: the card's busy share of the
    query's wall time and the kernels that take it (after the measured
    window, so the profiler's cost is not in the numbers above)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _, ctx = teola.query({"question": "what is fact 5 about optics",
                              "docs": docs}, timeout=600)
        torch.cuda.synchronize()
        wall = time.time() - t0
    if ctx.error is not None:
        raise ctx.error
    evs = [(getattr(e, "self_device_time_total", 0), e.key)
           for e in prof.key_averages()]
    dev_s = sum(t for t, _ in evs) / 1e6
    if dev_s <= 0:
        print("[profile] device time: not measured (the profiler saw no "
              "device activity)")
        return
    print(f"[profile] one query under the profiler: wall {wall:.3f} s, "
          f"device busy {dev_s:.3f} s ({100 * dev_s / wall:.1f}%) [{card}]")
    for t, key in sorted(evs, reverse=True)[:8]:
        print(f"[profile]   {t / 1e3:9.3f} ms  {key[:90]}")


def phase_serve(dev, card: str) -> dict:
    torch.cuda.reset_peak_memory_stats()
    engines = build_engines(device=dev)
    engines["core_llm"] = LLMEngine("core_llm", get_config("tinyllama-1.1b"),
                                    seed=SEED, max_batch=4, device=dev)
    app = naive_rag(engines)
    teola = Teola(app, engines)
    docs = doc_corpus(2)
    try:
        flash_prefill.launches = 0
        decode_attention.launches = 0
        t0 = time.time()
        _, ctx = teola.query({"question": "what is fact 1 about optics",
                              "docs": docs}, timeout=600)
        if ctx.error is not None:
            raise ctx.error
        warm = time.time() - t0
        dec0 = engines["core_llm"].stats["decode_tokens"]
        busy0 = _busy(engines)
        t0 = time.time()
        ctxs = [teola.submit({"question": q, "docs": docs})
                for q in QUESTIONS]
        for c in ctxs:
            if not c.done.wait(600):
                raise TimeoutError("serve query timed out")
        wall = time.time() - t0
        torch.cuda.synchronize()
        launches = {"flash_prefill": flash_prefill.launches,
                    "decode_attention": decode_attention.launches}
        busy = {k: v - busy0[k] for k, v in _busy(engines).items()}
        dec = engines["core_llm"].stats["decode_tokens"] - dec0
        _profiled_query(teola, docs, card)
    finally:
        teola.shutdown()
    for c in ctxs:
        if c.error is not None:
            raise c.error
        ans = c.store.get("answer")
        if not isinstance(ans, str) or not ans:
            raise AssertionError(f"empty answer for {c.qid}: {ans!r}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    mem = torch.cuda.max_memory_allocated() / 2**30
    nq = 1 + len(QUESTIONS)
    print(f"[serve] core_llm tinyllama-1.1b, 22 layers, fp32 weights; "
          f"warm-up query {warm:.3f} s [{card}]")
    for c in ctxs:
        print(f"[serve] {c.qid}: latency {c.latency:.3f} s, answer "
              f"{len(c.store['answer'].split())} words [{card}]")
    print(f"[serve] 4 queries in {wall:.3f} s; decode {dec} tokens, "
          f"{dec / wall:.1f} tokens/s over the window [{card}]")
    print("[serve] engine busy seconds in the window (host clock): " +
          ", ".join(f"{k} {v:.3f}" for k, v in busy.items()))
    print(f"[serve] max_memory_allocated {mem:.2f} GiB [{card}]")
    print(f"[serve] kernel launches on the main path ({nq} queries): "
          + ", ".join(f"{k} {n} ({n / nq:.1f} per query)"
                      for k, n in launches.items()))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    phase_toolchain(card)
    phase_build()
    kres = phase_kernels(dev)
    phase_model(dev)
    launches = phase_serve(dev, card)
    sources = {"flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                                 "src/repro/kernels/flash_prefill.py:75"),
               "decode_attention": (
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:107")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = kres[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
