#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --timing [--src DIR]
    python3 chip_smoke.py --moe

Phases, in order; any failure exits non-zero:
  1. toolchain: the card (nvidia-smi), torch / CUDA versions, nvcc, triton.
  2. build: nvcc compiles every kernel source, all at once; per kernel,
     registers and spills from ptxas, and the hd 256 instantiations of
     K1-K5 together; the tensor-core instructions in the SASS of K1 and
     K5, which share the tile kernel (cuobjdump).
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the main paths' shapes (TinyLlama-1.1B's heads, and
     Qwen1.5-MoE-A2.7B's and Gemma-2 9B's (hd 256, cap 50, window 64,
     fp32 K/V too) at batch 4; the paged kernels over a 129-block x
     16 bf16 pool with shuffled physical blocks and two rows sharing
     prefix blocks); the raw profiler records held against
     key_averages() on one profile; then each kernel timed beside its plain
     version and one library call: back-to-back calls between CUDA events
     (``ms``, which at decode sizes reads the wrapper's host work) and the
     device time of the kernels one call launches, from torch.profiler
     (``device_ms``), for the kernel and for the library call. K1 and K2
     with ``return_lse`` (o and each row's log-sum-exp) against their
     plain versions at hd 64, 128 and 256, on a rank's slice of a
     sequence-split cache: negative local prefixes, a chunk past the
     slice, lengths 0 (such rows exactly o = 0, lse = -inf, no NaN).
  4. model: TinyLlama-1.1B at full width cut to 2 layers (random weights
     from a seeded torch.Generator): prefill, Pass-3 partial prefill and
     decode on the card through the kernels, against the same code on the
     CPU; then the same on a paged pool (plus a speculative verify chunk),
     against the dense path on the card and the paged path on the CPU.
  5. serve, the dense path: naive-RAG under Teola with the full 22-layer
     TinyLlama-1.1B as the core LLM; 1 warm-up query, then 4 together.
  6. serve, the paged path: the same app and model under Teola with
     continuous batching, the core LLM on paged KV with the radix prefix
     cache, chunked prefill (128-token chunks) and prompt-lookup
     speculative decoding (k=3); 1 warm-up query, then 4 together.
  7. RWKV-6: the WKV scan kernel (K6) against its plain version at RWKV-6
     3B's heads (B=4, H=40, hd=64, S 512 / 128 / 1, plus hd=32) in fp32
     and bf16, timed, and a decode step timed over 32 states (one per
     layer, more than the L2 holds) as the model walks them; RWKV-6 3B at
     full width cut to 2 layers, card
     against CPU (prefill 100, 8 decode steps, a two-chunk prefill); then
     naive-RAG under Teola with the full 32-layer RWKV-6 3B as the core
     LLM on the dense path; 1 warm-up query, then 4 together.
  8. archs: each other architecture at full width cut to 2 layers, card
     against CPU as in phase 4 (prefill 100, partial prefill 40, 8 decode
     steps): Qwen1.5-MoE-A2.7B (MoE; dense cache and paged pool),
     DeepSeek-V3's dense-FFN stage (MLA at 128 heads; dense cache and
     paged pool), Hymba-1.5B (hybrid, windowed), ChatGLM3-6B (G = 16, half
     RoPE, QKV bias), DeepSeek-67B (G = 8), MusicGen-medium and
     InternVL2-26B on embedding inputs, Gemma-2 9B (a local and a global
     layer, hd 256, softcap; dense cache and paged pool); K1/K2 (K3-K5 on
     the pool) launch wherever the attention is GQA over a linear cache
     (Gemma-2's global layers; its local ones keep a ring); the CPU run
     replays the card's MoE top-k choices, so every row is held; a choice
     the CPU would have made otherwise is printed and must be a near-tie.
  9. moe: naive-RAG under Teola with the full 24-layer Qwen1.5-MoE-A2.7B
     as the core LLM (53.3 GiB of fp32 weights), on the dense path, then,
     that engine freed, on the paged path (as phases 5 and 6); the MoE
     dispatch on the engine's weights at a decode step and a verify
     chunk, timed beside the reference's all-experts form; the whole
     model on a dense cache and on a paged pool, the paged form replaying
     the dense form's routing, held together at every row; greedy decode
     alone and in a batch, and the two paths' core-LLM prompts, printed.
 10. hybrid: the same with the full 32-layer Hymba-1.5B on the dense
     path; its Mamba branch timed at a decode step and a 512-token
     prefill.
 10b. gemma: the same as phase 9 with the full 42-layer Gemma-2 9B
     (fp32, ~34 GiB) as the core LLM, dense then paged: K1/K2 on its 21
     global layers, K3-K5 on every layer, every launch at hd 256; the
     whole model paged vs dense within 1e-2 of the logits' scale; its
     whole-model dense decode step timed at batch 1 and 4 (for [cost]).
     After each paged phase ([moe], [gemma]) the first answer that
     differs from the dense path's is traced through the core LLM's
     generations: other token ids (the first diverging token, its top-2
     logit gap on each form replayed at batch 1, and Qwen's top-k gate
     gap there) or the same ids decoded to other text.
 11. train: training on the card. (a) K6's backward kernel, through
     rwkv6_scan's autograd Function, against autograd through the plain
     recurrence at RWKV-6 3B's heads (batch 2, S 1 / 100 / 128 / 512,
     fp32 and bf16), timed with the forward that saves the boundary
     states; (b) one train step of TinyLlama-1.1B, RWKV-6 3B,
     Qwen1.5-MoE-A2.7B and Hymba-1.5B at full width, 2 layers, card
     against CPU on the loss, every gradient leaf, gnorm and the new
     params (the CPU replaying the card's MoE top-k choices), and 3 steps
     of every other architecture on the card (finite, params changed);
     (c) the whole 22-layer TinyLlama-1.1B through the port's train
     launcher (batch 8 x 512, 2 microbatches, 20 steps, attention in
     checkpointed query blocks of 64: ce falls; its peak GiB and median
     step), its checkpoint read back bit for bit, one step profiled; (d)
     the whole
     32-layer RWKV-6 3B the same way (batch 2 x 512, 5 steps: finite,
     params changed, 32 K6 forward and 32 backward launches per step).
 11b. mesh: the sharded path (models/sharding.py, launch/shard_rules.py)
     at world size 1: a one-rank NCCL group and make_local_mesh(1, 1); the
     sharded 2-layer TinyLlama-1.1B (full width) prefill, partial prefill
     and decode through K1 and K2 on the reference's cache layout (the
     sequence over 'model': K1 / K2 with their LSE, the partials merged)
     and one sharded train step, each against the unsharded port on the
     card (within 1e-6, equal K1 and K2 launches); RWKV-6 3B (time mix over
     heads, channel mix over f), Hymba-1.5B (Mamba over dI) and
     DeepSeek-V3's MLA layers at full width, 2 layers, the same calls,
     within 1e-5 of the logits' scale; the expert-parallel MoE layer at EP
     size 1 against the one-device routed form (Qwen1.5-MoE-A2.7B's
     widths).
 11c. cost: the port's roofline prediction (launch/roofline_model.py over
     launch/mesh.py's H100 peaks, fp32) beside the measured time of the
     whole TinyLlama-1.1B and RWKV-6 3B train steps of phase 11 and of
     the whole Gemma-2 9B's dense decode step, which phase 10b times on
     its engine's weights at batch 1 and 4; the card's total_memory
     beside HBM_BYTES; and one ``python -m repro_torch.launch.dryrun``
     (a fake process group of 256 ranks, meta tensors) and its record.
 12. apps: every app of core/apps.py under every scheme of serve.py's
     SCHEMES, the 22-layer TinyLlama-1.1B as the core LLM on the dense
     path: advanced-RAG, search-gen and contextual retrieval under Teola
     measured as in phase 5; each baseline a warm-up and one query per app
     (LlamaDistPC last); every answer non-empty, naive- and advanced-RAG's
     chunks naming the question's topic.
 13. layers: the serving layers through the serve entry point's functions
     (build_parser, validate_args, make_engines, serve) with the same
     core: (a) two replicas with streaming, (b) SLO scheduling and a
     preemption replayed token-identically, (c) a crash of core-LLM
     replica 1 and its recovery, (d) disaggregated prefill/decode with KV
     migration, (e) overload control shedding part of a burst; every paged
     pool audits clean after release.
 13b. examples: repro_torch/examples/ quickstart, serve_batched and
     colocated_apps once each on the card (their printed lines checked).
 14. exit: ``python -m repro_torch.launch.serve`` in a process of its own
     serves one query and exits with 0.

After each serve window one more query runs under torch.profiler: the
card's busy share and, per hand-written kernel wrapper, the device time
of everything it launched (K2, K3 and K4: a split and a combine pass)
per call (K6's split into decode steps and prefills by the length of each
call); a wrapper that launched in that query and is charged no device time
fails the run.

--timing is not the smoke run: it runs only the timed phases (the kernels
of phase 3 and 7, K6's decode step cold and warm, K6's training forward
and backward at batch 2 x 512 as in phase 11 (a), the RWKV-6 serve
path with its profiled query, and 6 steps of the whole TinyLlama-1.1B
through the tree's own train launcher: peak GiB and median step, then
one step profiled) and prints no result line. With --src DIR
(accepted only with --timing) it takes repro_torch from DIR, so that two
trees' kernels are timed by the same code in one chip call, e.g. a parent
commit unpacked by ``git archive`` under build/.

--moe is not the smoke run either: it builds the grouped MoE expert kernel
(csrc/moe_experts.cu) and, at Qwen1.5-MoE-A2.7B's expert shapes on one
layer's fp32 weights, times it against its plain version and its byte
bound at T = 1, 4 and 16 tokens, then both forms of the routed dispatch
(grouped, sorted) at T = 1 to 512: the crossover of models/moe.py's
GROUPED_MAX_ASSIGN. It prints no result line.

Before the last line it prints a JSON line of per-kernel numbers and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Without a CUDA card, or without the repository's sources beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

TIMING = "--timing" in sys.argv
MOE_TIMING = "--moe" in sys.argv
if "--src" in sys.argv and not TIMING:
    sys.exit("chip_smoke: --src is accepted only with --timing")
SRC = (os.path.abspath(sys.argv[sys.argv.index("--src") + 1])
       if "--src" in sys.argv else
       os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.bridge import tree_to  # noqa: E402
from repro_torch.configs.base import InputShape, Stage, get_config  # noqa: E402,E501
from repro_torch.core.apps import ALL_APPS, build_engines, naive_rag  # noqa: E402,E501
from repro_torch.core.engine_pool import replicas_of  # noqa: E402
from repro_torch.core.teola import Teola  # noqa: E402
from repro_torch.engines.encoder_engines import (  # noqa: E402
    EmbeddingEngine, RerankEngine)
from repro_torch.engines.llm_engine import LLMEngine  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.chunk_prefill import (  # noqa: E402
    chunk_prefill_attention, chunk_prefill_attention_plain)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_prefill import (flash_prefill,  # noqa: E402
                                               flash_prefill_plain)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain, paged_gather,
    verify_attention, verify_attention_plain)
from repro_torch.kernels.rwkv6_scan import (rwkv6_scan,  # noqa: E402
                                            rwkv6_scan_plain)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.transformer import apply_model, init_params  # noqa: E402
from repro_torch.serving import kv_cache as kvc  # noqa: E402
from repro_torch.training.data import doc_corpus  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): one
# source, the port's roofline constants
from repro_torch.launch.mesh import (HBM_BW as HBM_BYTES_PER_S,  # noqa: E402
                                     HBM_BYTES,
                                     PEAK_FLOPS_BF16 as BF16_TC_FLOPS,
                                     PEAK_FLOPS_FP32 as FP32_FLOPS)
# K1 and K5 on the tensor cores (one tile kernel): an fp32 q and fp32
# probabilities in three bf16 pieces each, three bf16 products per fp32 one
TILE_PIECES = 3
# kernel vs plain version, on the same inputs (fp32 accumulation in both;
# bf16 outputs are compared at bf16 resolution)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# card vs CPU logits of the 2-layer model: K/V are stored in bf16, and a
# projection that differs in its last fp32 bit between the card's and the
# CPU's matmuls can round to a neighbouring bf16 value
MODEL_TOL = 1e-2
H, K, HD, T = 32, 4, 64, 512          # TinyLlama-1.1B attention, max_len
TINY_HEADS = (H, K, HD)
QWEN_HEADS = (16, 16, 128)            # Qwen1.5-MoE-A2.7B attention (G = 1)
GEMMA_HEADS = (16, 8, 256)            # Gemma-2 9B attention (G = 2, hd 256)
GEMMA_CAP = 50.0                      # its attention-logit softcap
NB, BS = 129, 16                      # the serve path's paged pool
SEED = 0
PAGED = [paged_decode_attention, verify_attention, chunk_prefill_attention]


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


def _device_records(prof):
    """(name, start ns, device us) of each device-side record the profiler
    saw (kernels, copies, fills), read from its raw results: building its
    Python event tree (``events()``, ``key_averages()``) costs about 0.2
    ms per record, 71 s for the 380k records of a Qwen1.5-MoE query."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]


def _device_rows(prof):
    """(key, device us, count) of each device-side row the profiler saw,
    one row per kernel name. CPU ops are left out: they also carry the
    time of the kernels they launch, which those kernels' own rows hold."""
    rows = {}
    for name, _, us in _device_records(prof):
        t, n = rows.get(name, (0.0, 0))
        rows[name] = (t + us, n + 1)
    return [(k, t, n) for k, (t, n) in rows.items()]


def check_device_records(fn, iters: int = 5):
    """Fails unless ``_device_rows`` (the raw records) and torch.profiler's
    own ``key_averages()`` read one profile of ``iters`` calls of ``fn``
    alike: the same kernels, the same counts, and the same device time
    within 1 us per record (the event tree keeps whole microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    raw = {k: (t, n) for k, t, n in _device_rows(prof)}
    avg = {e.key: (e.self_device_time_total, e.count)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)}
    bad = sorted(k for k in raw.keys() | avg.keys()
                 if k not in raw or k not in avg
                 or raw[k][1] != avg[k][1]
                 or abs(raw[k][0] - avg[k][0]) > raw[k][1] + 1e-3)
    for k in sorted(raw):
        print(f"[kernels] profiler records {_short(k)}: raw {raw[k][0]:.3f} "
              f"us / {raw[k][1]}, key_averages {avg.get(k, (0.0, 0))[0]:.3f}"
              f" us / {avg.get(k, (0.0, 0))[1]}")
    if not raw or bad:
        raise AssertionError(f"raw device records disagree with "
                             f"key_averages() on {bad or 'an empty profile'}")


def device_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 3):
    """Device time of one call of ``fn`` in ms, from torch.profiler over
    ``iters`` calls (after ``warmup``): for each kernel, copy and fill the
    calls launch, its mean recorded duration times its launches per call
    (its recorded count over ``iters``, rounded, at least 1), summed. Means,
    because a window can lose some of its records: on one H100 the same
    K6 call has read 0.2703 and 0.2079 ms of summed device time in two
    runs, against 0.280 ms of CUDA-event time in both. The rounding takes
    every function timed here to launch the same kernels on every call,
    as the wrappers and the library calls do. A window with no device row
    at all is asked again, up to ``tries`` windows; None where none saw
    device activity. The inputs stay in the 50 MB L2 cache across the
    calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(t, n) for _, t, n in _device_rows(prof) if n > 0]
        if sum(t for t, _ in rows) > 0:
            return sum(t / n * max(1, round(n / iters)) for t, n in rows) / 1e3
    return None


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


def ptxas_kernels(text: str):
    """[(kernel, registers, spill store bytes, spill load bytes)] from
    nvcc's -Xptxas -v output, kernel names demangled (where c++filt is
    found) and shortened as the profile's are."""
    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), *spill])
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True).stdout
        for r, dm in zip(rows, out.splitlines()):
            r[0] = _short(dm)
    return [tuple(r) for r in rows]


def sass_tensor_ops(path: str) -> dict:
    """Counts of HGMMA (wgmma) and HMMA (mma.sync) instructions in a
    library's SASS, from cuobjdump next to nvcc."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\.", sass))
            for op in ("HGMMA", "HMMA")}


def phase_build():
    t0 = time.time()
    log = build.build_all()
    print(f"[build] {len(log)} kernel libraries in {time.time() - t0:.1f} s "
          f"(nvcc in parallel)")
    hd256 = []
    for name, rec in log.items():
        print(f"[build] {name}: {rec['seconds']:.1f} s")
        for kern, regs, st, ld in ptxas_kernels(rec["ptxas"]):
            print(f"[build]   {kern}: {regs} registers per thread, spills "
                  f"{st} B stored / {ld} B loaded")
            if "<256," in kern:
                hd256.append((kern, regs, st, ld))
    # the hd 256 instantiations of K1-K5 (Gemma-2's head dim), together
    for kern, regs, st, ld in hd256:
        print(f"[build] hd 256: {kern}: {regs} registers, spills {st} B "
              f"stored / {ld} B loaded")
    print(f"[build] hd 256: {len(hd256)} instantiations, "
          f"{sum(1 for r in hd256 if r[2] or r[3])} with spills, at most "
          f"{max((r[1] for r in hd256), default=0)} registers")
    if not hd256:
        raise AssertionError("no hd 256 instantiation was built")
    for name in ("flash_prefill", "chunk_prefill"):
        ops = sass_tensor_ops(log[name]["path"])
        print(f"[build] {name} SASS: {ops['HGMMA']} HGMMA, {ops['HMMA']} "
              f"HMMA instructions")
        if ops["HGMMA"] == 0:
            raise AssertionError(f"{name} runs no wgmma instruction")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, timed

def _kv(B, rs, dev, kh=K, hd=HD, kvdt=torch.bfloat16):
    return [torch.from_numpy(rs.standard_normal((B, T, kh, hd)).astype(
        np.float32)).to(dev, kvdt) for _ in range(2)]


def _prefill_case(B, Sq, prefix, dev, window=None, cap=None,
                  qdt=torch.float32, heads=TINY_HEADS, kvdt=torch.bfloat16):
    nh, kh, hd = heads
    rs = np.random.RandomState(B * 1000 + Sq)
    q = torch.from_numpy(rs.standard_normal((B, Sq, nh, hd)).astype(
        np.float32)).to(dev, qdt)
    k, v = _kv(B, rs, dev, kh, hd, kvdt)
    pre = torch.tensor(prefix, dtype=torch.int32, device=dev)
    kw = dict(prefix_len=pre, window=window, cap=cap)
    return (q, k, v, kw)


def _decode_case(B, length, dev, window=None, cap=None, qdt=torch.float32,
                 heads=TINY_HEADS):
    nh, kh, hd = heads
    rs = np.random.RandomState(B * 7 + 1)
    q = torch.from_numpy(rs.standard_normal((B, nh, hd)).astype(
        np.float32)).to(dev, qdt)
    k, v = _kv(B, rs, dev, kh, hd)
    ln = torch.tensor(length, dtype=torch.int32, device=dev)
    return (q, k, v, ln, dict(window=window, cap=cap))


def _kv_row_bytes(k):
    """Bytes of one key's K and V rows over the kv heads."""
    return k.shape[-2] * k.shape[-1] * k.element_size() * 2


def _prefill_work(q, prefix, k):
    B, Sq, nh, hd = q.shape
    pre = prefix.tolist()
    kv_rows = sum(min(T, p + Sq) for p in pre)
    nbytes = (q.numel() * q.element_size() * 2           # q in, o out
              + kv_rows * _kv_row_bytes(k))               # k and v
    keys = sum(p * Sq + Sq * (Sq + 1) // 2 for p in pre)  # causal pairs
    flops = 4 * hd * nh * keys
    return nbytes, flops


def _decode_work(q, length, k):
    B, nh, hd = q.shape
    kv_rows = sum(min(T, n) for n in length.tolist())
    nbytes = q.numel() * q.element_size() * 2 + kv_rows * _kv_row_bytes(k)
    flops = 4 * hd * nh * kv_rows
    return nbytes, flops


def _bound(nbytes, flops, flops_per_s=FP32_FLOPS):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
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


def _hd256_here() -> bool:
    """Whether the tree under test has the hd 256 kernels. Only --timing
    may run a tree without them (a parent commit under --src); the smoke
    run always holds them."""
    return not TIMING or 256 in getattr(build, "HEAD_DIMS", ())


def _lse_here() -> bool:
    """Whether the tree under test's K1 and K2 return their LSE (a parent
    commit under --src may predate it)."""
    import inspect
    return "return_lse" in inspect.signature(flash_prefill).parameters


def _time_prefill(q, k, v, kw, label):
    """K1 timed beside its plain version and SDPA (which applies no
    softcap: no single PyTorch call does). Returns the kernel's record."""
    ms = cuda_ms(lambda: flash_prefill(q, k, v, **kw))
    dev_ms = device_ms(lambda: flash_prefill(q, k, v, **kw))
    plain = cuda_ms(lambda: flash_prefill_plain(q, k, v, **kw))
    sdpa = _sdpa_prefill(q, k, v, kw["prefix_len"])
    lib, lib_dev = cuda_ms(sdpa), device_ms(sdpa)
    nbytes, flops = _prefill_work(q, kw["prefix_len"], k)
    bound, by = _bound(nbytes, flops)
    tc_bound, tc_by = _bound(nbytes, TILE_PIECES * flops, BF16_TC_FLOPS)
    lse_dev = device_ms(lambda: flash_prefill(q, k, v, return_lse=True,
                                              **kw)) if _lse_here() else None
    print(f"[kernels] flash_prefill {label}: kernel {ms:.4f} ms (device "
          f"{_fmt(dev_ms)}; with the LSE {_fmt(lse_dev)}), plain "
          f"{plain:.4f} ms, sdpa {lib:.4f} ms (device "
          f"{_fmt(lib_dev)}), bound {bound:.4f} ms ({by}, fp32 at 67 "
          f"TFLOP/s), tensor-core bound {tc_bound:.4f} ms ({tc_by}, "
          f"{TILE_PIECES} bf16 products per fp32 one at 989 TFLOP/s)")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, tc_bound_ms=tc_bound, library_ms=lib,
                library_device_ms=lib_dev, lse_device_ms=lse_dev)


def _time_decode(q, k, v, ln, kw, label):
    """K2 timed beside its plain version and SDPA."""
    ms = cuda_ms(lambda: decode_attention(q, k, v, ln, **kw))
    dev_ms = device_ms(lambda: decode_attention(q, k, v, ln, **kw))
    plain = cuda_ms(lambda: decode_attention_plain(q, k, v, ln, **kw))
    sdpa = _sdpa_decode(q, k, v, ln)
    lib, lib_dev = cuda_ms(sdpa), device_ms(sdpa)
    nbytes, flops = _decode_work(q, ln, k)
    bound, by = _bound(nbytes, flops)
    lse_dev = device_ms(lambda: decode_attention(
        q, k, v, ln, return_lse=True, **kw)) if _lse_here() else None
    print(f"[kernels] decode_attention {label}: kernel {ms:.4f} ms (device "
          f"{_fmt(dev_ms)}: split + combine; with the LSE {_fmt(lse_dev)}), "
          f"plain {plain:.4f} ms, sdpa {lib:.4f} ms (device "
          f"{_fmt(lib_dev)}), bound {bound:.4f} ms ({by})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib, library_device_ms=lib_dev,
                lse_device_ms=lse_dev)


LSE_TOL = 1e-4                        # each row's log-sum-exp, absolute


def _lse_errs(name, got, want, qdt, label):
    """K1's or K2's (o, lse) against its plain version's: o within TOL,
    the finite LSEs within LSE_TOL, and the rows that see no key exactly
    o = 0 and lse = -inf in both, with no NaN anywhere. Returns (o error,
    lse error, empty rows)."""
    (o, lse), (o_p, lse_p) = got, want
    empty = torch.isneginf(lse_p)
    if torch.isnan(o).any() or torch.isnan(lse).any():
        raise AssertionError(f"{name} {label}: NaN in (o, lse)")
    if not torch.equal(torch.isneginf(lse), empty) or \
            (o.float()[empty] != 0).any():
        raise AssertionError(f"{name} {label}: empty rows differ from the "
                             f"plain version's (lse -inf, o = 0)")
    e_o = (o.float() - o_p.float()).abs().max().item()
    e_l = (lse - lse_p)[~empty].abs().max().item() if (~empty).any() \
        else 0.0
    print(f"[kernels] {name} {label} with LSE: o {e_o:.3e} (tolerance "
          f"{TOL[qdt]:g}), lse {e_l:.3e} (tolerance {LSE_TOL:g}), "
          f"{int(empty.sum())} empty rows (o = 0, lse = -inf)")
    if not (e_o <= TOL[qdt] and e_l <= LSE_TOL):
        raise AssertionError(f"{name} {label} with LSE: {e_o}, {e_l}")
    return e_o, e_l, int(empty.sum())


def _check_lse(dev, res):
    """K1 and K2 with ``return_lse`` against their plain versions at hd 64,
    128 and 256, on the inputs a rank's slice of a sequence-split cache
    gives them: a negative local prefix (rows before the slice see no
    key), a chunk past the slice, and lengths 0 (nothing in the slice)."""
    f32, bf16 = torch.float32, torch.bfloat16
    heads = [(TINY_HEADS, None), (QWEN_HEADS, None)]
    if _hd256_here():
        heads.append((GEMMA_HEADS, GEMMA_CAP))
    empties = [0, 0]
    for (nh, kh, hd), cap in heads:
        for qdt in (f32, bf16):
            # prefixes local to a slice: before it, straddling its start,
            # inside it, and past its end (total clipped by the slice)
            q, k, v, kw = _prefill_case(4, 64, [-100, -10, 0, 480], dev,
                                        cap=cap, qdt=qdt,
                                        heads=(nh, kh, hd))
            label = f"B=4 Sq=64 prefix=[-100,-10,0,480] q={str(qdt)[6:]} " \
                f"H,K,hd={(nh, kh, hd)} cap={cap}"
            got = flash_prefill(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            e_o, e_l, n = _lse_errs("flash_prefill", got, flash_prefill_plain(
                q, k, v, return_lse=True, **kw), qdt, label)
            empties[0] += n
            res["flash_prefill"]["lse_max_abs_err"] = max(
                res["flash_prefill"].get("lse_max_abs_err", 0.0), e_l)
            q, k, v, ln, kw = _decode_case(4, [0, 1, 300, 512], dev,
                                           cap=cap, qdt=qdt,
                                           heads=(nh, kh, hd))
            label = f"B=4 length=[0,1,300,512] q={str(qdt)[6:]} " \
                f"H,K,hd={(nh, kh, hd)} cap={cap}"
            got = decode_attention(q, k, v, ln, return_lse=True, **kw)
            torch.cuda.synchronize()
            e_o, e_l, n = _lse_errs("decode_attention", got,
                                    decode_attention_plain(
                                        q, k, v, ln, return_lse=True, **kw),
                                    qdt, label)
            empties[1] += n
            res["decode_attention"]["lse_max_abs_err"] = max(
                res["decode_attention"].get("lse_max_abs_err", 0.0), e_l)
    if not all(empties):
        raise AssertionError(f"no empty rows were held: {empties}")


def phase_kernels(dev) -> dict:
    """Returns {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms, ...}} at the representative main-path shape, with the
    same at Gemma-2's heads under "hd256"."""
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

    f32, bf16, tiny, qwen = (torch.float32, torch.bfloat16, TINY_HEADS,
                             QWEN_HEADS)
    pre4 = [0, 37, 100, 200]
    cases = []
    for B in (1, 4):
        for Sq in (64, 256):
            cases.append((B, Sq, pre4[:B], None, None, f32, tiny, bf16))
    cases.append((4, 256, pre4, 100, 50.0, f32, tiny, bf16))
    cases.append((4, 128, pre4, None, None, bf16, tiny, bf16))
    # Qwen1.5-MoE's heads, at the [moe] dense path's batch bucket
    cases += [(1, 100, [0], None, None, f32, qwen, bf16),
              (4, 128, pre4, None, None, f32, qwen, bf16)]
    gemma = GEMMA_HEADS
    if _hd256_here():
        # Gemma-2 9B's heads at the [gemma] path's batch bucket: its global
        # layers' shape (cap 50), the window of its local layers, a bf16
        # q, and fp32 K/V (the CUDA-core body)
        cases += [(4, 256, pre4, None, GEMMA_CAP, f32, gemma, bf16),
                  (4, 256, pre4, 64, GEMMA_CAP, f32, gemma, bf16),
                  (4, 128, pre4, None, GEMMA_CAP, bf16, gemma, bf16),
                  (4, 256, pre4, 64, GEMMA_CAP, f32, gemma, f32)]
    else:
        print("[kernels] hd 256 cases: this tree has no hd 256 kernels")
    for B, Sq, prefix, window, cap, qdt, heads, kvdt in cases:
        q, k, v, kw = _prefill_case(B, Sq, prefix, dev, window, cap, qdt,
                                    heads, kvdt)
        got = flash_prefill(q, k, v, **kw)
        torch.cuda.synchronize()
        check("flash_prefill", got, flash_prefill_plain(q, k, v, **kw), qdt,
              f"B={B} Sq={Sq} prefix={prefix} window={window} cap={cap} "
              f"q={str(qdt)[6:]} kv={str(kvdt)[6:]} H,K,hd={heads}")
    lens = [1, 130, 300, 512]
    dcases = [(1, [300], None, None, f32, tiny),
              (4, lens, None, None, f32, tiny),
              (4, lens, 64, 50.0, f32, tiny),
              (4, lens, None, None, bf16, tiny),
              (4, [63, 64, 65, 511], None, None, f32, tiny),
              (4, lens, None, None, f32, qwen),
              (4, [63, 64, 65, 511], None, None, f32, qwen)]
    if _hd256_here():
        dcases += [(4, lens, None, GEMMA_CAP, f32, gemma),
                   (4, lens, 64, GEMMA_CAP, f32, gemma),
                   (4, lens, None, GEMMA_CAP, bf16, gemma),
                   (4, [63, 64, 65, 511], None, GEMMA_CAP, f32, gemma)]
    for B, length, window, cap, qdt, heads in dcases:
        q, k, v, ln, kw = _decode_case(B, length, dev, window, cap, qdt,
                                       heads)
        got = decode_attention(q, k, v, ln, **kw)
        torch.cuda.synchronize()
        check("decode_attention", got, decode_attention_plain(q, k, v, ln,
                                                              **kw),
              qdt, f"B={B} length={length} window={window} cap={cap} "
              f"q={str(qdt)[6:]} H,K,hd={heads}")

    if _lse_here():
        _check_lse(dev, res)
    else:
        print("[kernels] LSE cases: this tree's K1 and K2 return no LSE")

    # the profiler reading that every device time below rests on
    q, k, v, ln, _ = _decode_case(4, lens, dev)
    check_device_records(lambda: decode_attention(q, k, v, ln))

    # timings at the representative main-path shapes (batch bucket 4)
    for B, Sq in ((1, 64), (4, 64), (4, 256)):
        prefix = pre4[:B]
        q, k, v, kw = _prefill_case(B, Sq, prefix, dev)
        res["flash_prefill"].update(_time_prefill(
            q, k, v, kw, f"B={B} Sq={Sq} T={T} prefix={prefix}"))
    for B, length in ((1, [300]), (4, lens)):
        q, k, v, ln, kw = _decode_case(B, length, dev)
        res["decode_attention"].update(_time_decode(
            q, k, v, ln, kw, f"B={B} T={T} length={length}"))
    if _hd256_here():
        # Gemma-2 9B's global layers at the [gemma] dense path's bucket
        q, k, v, kw = _prefill_case(4, 256, pre4, dev, cap=GEMMA_CAP,
                                    heads=gemma)
        res["flash_prefill"]["hd256"] = _time_prefill(
            q, k, v, kw, f"B=4 Sq=256 T={T} prefix={pre4} cap={GEMMA_CAP} "
            f"H,K,hd={gemma}")
        q, k, v, ln, kw = _decode_case(4, lens, dev, cap=GEMMA_CAP,
                                       heads=gemma)
        res["decode_attention"]["hd256"] = _time_decode(
            q, k, v, ln, kw, f"B=4 T={T} length={lens} cap={GEMMA_CAP} "
            f"H,K,hd={gemma}")
    return res


# ---------------------------------------------------------------------------
# phase 3, paged kernels (K3 verify, K4 paged decode, K5 chunked prefill)

PAGED_PLAIN = {paged_decode_attention: paged_decode_attention_plain,
               verify_attention: verify_attention_plain,
               chunk_prefill_attention: chunk_prefill_attention_plain}


def _pool_and_tables(B, dev, kh=K, hd=HD, kvdt=torch.bfloat16):
    """A (NB, BS, kh, hd) K/V pool pair (bf16 as the engines', or kvdt)
    and (B, T/BS) tables of shuffled physical blocks, rows 0 and 1
    sharing their first 4 blocks as a copy-on-write fork would."""
    rs = np.random.RandomState(SEED + B)
    kp, vp = [torch.from_numpy(rs.standard_normal((NB, BS, kh, hd)).astype(
        np.float32)).to(dev, kvdt) for _ in range(2)]
    t = rs.permutation(np.arange(1, NB))[:B * (T // BS)].reshape(B, -1)
    if B > 1:
        t[1, :4] = t[0, :4]
    return kp, vp, torch.tensor(t, dtype=torch.int32, device=dev)


def _paged_case(fn, B, Sq, pos, dev, qdt=torch.float32, heads=TINY_HEADS,
                kvdt=torch.bfloat16):
    """Inputs of one paged kernel call: pos is the per-row length (K3,
    K4) or chunk start (K5)."""
    nh, kh, hd = heads
    rs = np.random.RandomState(B * 100 + Sq)
    shape = (B, nh, hd) if fn is paged_decode_attention else (B, Sq, nh, hd)
    q = torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).to(
        dev, qdt)
    kp, vp, t = _pool_and_tables(B, dev, kh, hd, kvdt)
    return q, kp, vp, t, torch.tensor(pos, dtype=torch.int32, device=dev)


def _query_positions(fn, q, pos):
    """(B, Sq) absolute positions of the call's query rows."""
    Sq = 1 if q.dim() == 3 else q.shape[1]
    first = pos.long() if fn is chunk_prefill_attention else pos.long() - Sq
    return first[:, None] + torch.arange(Sq, device=q.device)[None, :]


def _paged_work(fn, q, pos, kp):
    """Bytes (q in, o out, the table-addressed K/V rows the data needs) and
    flops (4*hd per query-head/key pair) of one call."""
    nh, hd = q.shape[-2:]
    qpos = _query_positions(fn, q, pos)
    rows = int((qpos[:, -1] + 1).sum())
    nbytes = q.numel() * q.element_size() * 2 + rows * _kv_row_bytes(kp)
    flops = 4 * hd * nh * int((qpos + 1).sum())
    return nbytes, flops


def _sdpa_paged(fn, q, kp, vp, t, pos):
    """One library call computing the kernel's function on the
    PRE-GATHERED linear view (timed only, never used by the port; the
    gather itself is not timed: no single PyTorch call reads through a
    block table)."""
    kh = paged_gather(kp, t).float().transpose(1, 2).contiguous()
    vh = paged_gather(vp, t).float().transpose(1, 2).contiguous()
    qh = q[:, :, None] if q.dim() == 3 else q.transpose(1, 2)
    qpos = _query_positions(fn, q, pos)
    mask = (torch.arange(kh.shape[2], device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]
    return _sdpa(qh, kh, vh, mask)


def _time_paged(fn, q, kp, vp, t, p, kw, label):
    """One paged kernel timed beside its plain version and SDPA on the
    pre-gathered view. Returns the kernel's record."""
    plain = PAGED_PLAIN[fn]
    ms = cuda_ms(lambda: fn(q, kp, vp, t, p, **kw))
    dev_ms = device_ms(lambda: fn(q, kp, vp, t, p, **kw))
    plain_ms = cuda_ms(lambda: plain(q, kp, vp, t, p, **kw))
    sdpa = _sdpa_paged(fn, q, kp, vp, t, p)
    lib, lib_dev = cuda_ms(sdpa), device_ms(sdpa)
    nbytes, flops = _paged_work(fn, q, p, kp)
    bound, by = _bound(nbytes, flops)
    extra, tc = "", {}
    if fn is chunk_prefill_attention:     # K1's tile kernel
        tc_bound, tc_by = _bound(nbytes, TILE_PIECES * flops, BF16_TC_FLOPS)
        extra = (f", tensor-core bound {tc_bound:.4f} ms ({tc_by}, "
                 f"{TILE_PIECES} bf16 products per fp32 one at 989 "
                 f"TFLOP/s)")
        tc = dict(tc_bound_ms=tc_bound)
    print(f"[kernels] {fn.__name__} {label} pool {NB}x{BS}: kernel {ms:.4f} "
          f"ms (device {_fmt(dev_ms)}), plain {plain_ms:.4f} ms, sdpa on the "
          f"pre-gathered view {lib:.4f} ms (device {_fmt(lib_dev)}; gather "
          f"not timed), bound {bound:.4f} ms ({by}, fp32 at 67 TFLOP/s)"
          f"{extra}")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib, library_device_ms=lib_dev, **tc)


def phase_paged_kernels(dev) -> dict:
    """K3, K4 and K5 against their plain versions, then timed. Returns
    {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms, ...}} at the representative serve-path shape, with the
    same at Gemma-2's heads under "hd256"."""
    res = {fn.__name__: {"max_abs_err": 0.0} for fn in PAGED}
    f32, bf16 = torch.float32, torch.bfloat16
    lengths = [1, 130, 300, 512]
    starts = [0, 37, 100, 200]
    cases = []
    for fn, Sq, pos in ((paged_decode_attention, 1, lengths),
                        (verify_attention, 4, [4] + lengths[1:])):
        cases += [(fn, 1, Sq, [300], None, None, f32),
                  (fn, 4, Sq, pos, None, None, f32),
                  (fn, 4, Sq, pos, 64, 50.0, f32),
                  (fn, 4, Sq, pos, None, None, bf16)]
    cases.append((verify_attention, 4, 4, [64, 65, 129, 511], None, None,
                  f32))
    for Sq in (64, 128):
        cases += [(chunk_prefill_attention, 1, Sq, [37], None, None, f32),
                  (chunk_prefill_attention, 4, Sq, starts, None, None, f32)]
    cases += [(chunk_prefill_attention, 4, 128, starts, 100, 50.0, f32),
              (chunk_prefill_attention, 4, 64, starts, None, None, bf16)]
    cases = [c + (TINY_HEADS, bf16) for c in cases]
    # Qwen1.5-MoE's heads, at the [moe-paged] path's batch bucket
    for fn, Sq, pos in ((paged_decode_attention, 1, lengths),
                        (verify_attention, 4, [4] + lengths[1:]),
                        (verify_attention, 4, [64, 65, 129, 511]),
                        (chunk_prefill_attention, 128, starts),
                        (chunk_prefill_attention, 64, [0, 16, 63, 384])):
        cases.append((fn, 4, Sq, pos, None, None, f32, QWEN_HEADS, bf16))
    if _hd256_here():
        # Gemma-2 9B's heads at the [gemma-paged] path's batch bucket: cap
        # 50 on every layer, the local layers' window, a bf16 q, and an
        # fp32 pool (the CUDA-core body of K5)
        for fn, Sq, pos in ((paged_decode_attention, 1, lengths),
                            (verify_attention, 4, [4] + lengths[1:]),
                            (chunk_prefill_attention, 128, starts)):
            cases += [(fn, 4, Sq, pos, None, GEMMA_CAP, f32, GEMMA_HEADS,
                       bf16),
                      (fn, 4, Sq, pos, 64, GEMMA_CAP, f32, GEMMA_HEADS, bf16),
                      (fn, 4, Sq, pos, None, GEMMA_CAP, bf16, GEMMA_HEADS,
                       bf16)]
        cases.append((chunk_prefill_attention, 4, 128, starts, 64, GEMMA_CAP,
                      f32, GEMMA_HEADS, f32))
    for fn, B, Sq, pos, window, cap, qdt, heads, kvdt in cases:
        q, kp, vp, t, p = _paged_case(fn, B, Sq, pos, dev, qdt, heads, kvdt)
        kw = dict(window=window, cap=cap)
        got = fn(q, kp, vp, t, p, **kw)
        torch.cuda.synchronize()
        want = PAGED_PLAIN[fn](q, kp, vp, t, p, **kw)
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[qdt]
        print(f"[kernels] {fn.__name__} B={B} Sq={Sq} pos={pos} "
              f"window={window} cap={cap} q={str(qdt)[6:]} "
              f"kv={str(kvdt)[6:]} H,K,hd={heads}: max_abs_err "
              f"{err:.3e} (tolerance {tol:g})")
        if not (err <= tol):
            raise AssertionError(f"{fn.__name__}: {err} > {tol}")
        r = res[fn.__name__]
        r["max_abs_err"] = max(r["max_abs_err"], err)

    # timings at the representative serve-path shapes (batch bucket 4),
    # the B=4 shape last so that it is the one reported
    for fn, Sq, pos in ((paged_decode_attention, 1, [300]),
                        (paged_decode_attention, 1, lengths),
                        (verify_attention, 4, [300]),
                        (verify_attention, 4, [4] + lengths[1:]),
                        (chunk_prefill_attention, 64, starts),
                        (chunk_prefill_attention, 128, starts)):
        q, kp, vp, t, p = _paged_case(fn, len(pos), Sq, pos, dev)
        res[fn.__name__].update(_time_paged(
            fn, q, kp, vp, t, p, {}, f"B={len(pos)} Sq={Sq} pos={pos}"))
    if _hd256_here():
        for fn, Sq, pos in ((paged_decode_attention, 1, lengths),
                            (verify_attention, 4, [4] + lengths[1:]),
                            (chunk_prefill_attention, 128, starts)):
            q, kp, vp, t, p = _paged_case(fn, 4, Sq, pos, dev,
                                          heads=GEMMA_HEADS)
            res[fn.__name__]["hd256"] = _time_paged(
                fn, q, kp, vp, t, p, dict(cap=GEMMA_CAP),
                f"B=4 Sq={Sq} pos={pos} cap={GEMMA_CAP} "
                f"H,K,hd={GEMMA_HEADS}")
    return res


# ---------------------------------------------------------------------------
# phase 4: 2-layer TinyLlama-1.1B, card against CPU

def two_layer(name):
    """``name`` at full width, 2 layers: its first stage's pattern twice, or
    once where it has two layers (Gemma-2's local and global pair)."""
    cfg = get_config(name)
    pattern = cfg.stages[0].pattern
    return dataclasses.replace(cfg, name=name + "-2l", stages=(
        Stage(pattern=pattern, repeat=max(1, 2 // len(pattern))),))


SCHED = [(0, 100), (100, 140)] + [(140 + i, 141 + i) for i in range(8)]


def run_model(cfg, params, dev, toks, *, paged=False, verify_tail=False,
              sched=SCHED, **kw):
    """By default prefill 100 tokens, partial-prefill 40 more on the same
    cache, then 8 decode steps, all fed fixed tokens (so both devices see
    the same inputs); ``sched`` gives other (lo, hi) token ranges. With
    ``verify_tail`` one more 4-token chunk at 148. With ``paged`` the
    cache is a paged pool read through a shuffled block table and the
    tail is a speculative verify chunk. ``kw`` goes to ``apply_model``
    (``cache_batch=1`` under a mesh). Returns the logits of every call
    and the cache."""
    sched = list(sched)
    tail = (148, 152)
    if verify_tail:
        sched.append(tail)
    if paged:
        cache = kvc.init_paged_pool(cfg, 1 + T // BS, BS, device=dev)
        table = np.random.RandomState(SEED).permutation(
            np.arange(1, 1 + T // BS))[None]
        kw["block_tables"] = torch.tensor(table, dtype=torch.int32,
                                          device=dev)
    else:
        cache = kvc.init_cache(cfg, 1, T, device=dev)
    outs = []
    with torch.inference_mode():
        for lo, hi in sched:
            x = torch.as_tensor(toks[None, lo:hi], device=dev)
            logits, cache = apply_model(cfg, params, x, cache, lo,
                                        verify=paged and (lo, hi) == tail,
                                        **kw)
            outs.append(logits.float().cpu())
    return outs, cache


def _max_err(got, want):
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def phase_model(dev):
    cfg = two_layer("tinyllama-1.1b")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    params_cpu = init_params(cfg, gen, torch.float32, "cpu")
    params_dev = tree_to(params_cpu, dev)
    toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size, 152)
    n0 = (flash_prefill.launches, decode_attention.launches)
    got, _ = run_model(cfg, params_dev, dev, toks)
    torch.cuda.synchronize()
    if (flash_prefill.launches - n0[0], decode_attention.launches - n0[1]) \
            != (2 * 2, 8 * 2):
        raise AssertionError("model phase did not run through the kernels")
    want, _ = run_model(cfg, params_cpu, "cpu", toks)
    err = _max_err(got, want)
    scale = max(w.abs().max().item() for w in want)
    finite = all(torch.isfinite(g).all().item() for g in got)
    print(f"[model] {cfg.name} (d={cfg.d_model}, H={cfg.num_heads}, "
          f"K={cfg.num_kv_heads}, 2 layers): card vs CPU max |dlogits| "
          f"{err:.3e} over |logits| <= {scale:.3f} (tolerance {MODEL_TOL:g})")
    if not finite or not (err <= MODEL_TOL):
        raise AssertionError(f"model phase: err {err}, finite {finite}")

    # the paged form: prefill 100 and a chunk of 40 (K5), 8 decode steps
    # (K4), one verify chunk of 4 (K3), 2 layers each
    n0 = [fn.launches for fn in PAGED]
    paged, _ = run_model(cfg, params_dev, dev, toks, paged=True,
                      verify_tail=True)
    torch.cuda.synchronize()
    got_n = [fn.launches - n for fn, n in zip(PAGED, n0)]
    if got_n != [8 * 2, 1 * 2, 2 * 2]:
        raise AssertionError(f"paged model phase launched {got_n} "
                             f"(K4, K3, K5), expected [16, 2, 4]")
    dense, _ = run_model(cfg, params_dev, dev, toks, verify_tail=True)
    paged_cpu, _ = run_model(cfg, params_cpu, "cpu", toks, paged=True,
                          verify_tail=True)
    e_dense, e_cpu = _max_err(paged, dense), _max_err(paged, paged_cpu)
    finite = all(torch.isfinite(g).all().item() for g in paged)
    print(f"[model] paged pool {1 + T // BS}x{BS}, shuffled table: card "
          f"paged vs card dense max |dlogits| {e_dense:.3e}, card paged vs "
          f"CPU paged {e_cpu:.3e} (tolerance {MODEL_TOL:g}); launches K4 "
          f"{got_n[0]}, K3 {got_n[1]}, K5 {got_n[2]}")
    if not finite or not (max(e_dense, e_cpu) <= MODEL_TOL):
        raise AssertionError(f"paged model phase: {e_dense}, {e_cpu}, "
                             f"finite {finite}")


# ---------------------------------------------------------------------------
# phase 5: the main path

QUESTIONS = ["what is fact 3 about optics", "what is fact 7 about finance",
             "what is fact 12 about optics", "what is fact 30 about finance"]


# the wrapper that launches each hand-written kernel: K2's, K3's and K4's
# split and combine passes are templates of csrc/split_kv.cuh, K1's and
# K5's tensor-core kernel is the template of csrc/flash_tile.cuh, each told
# apart by its addressing policy; the others are <name>_kernel in an
# anonymous namespace of their source (the fp32-K/V bodies of K1 and K5 in
# a nested one)
_ANON_KERNELS = (("fp32kv::flash_prefill_fp32kv_kernel<", "flash_prefill"),
                 ("fp32kv::chunk_prefill_fp32kv_kernel<",
                  "chunk_prefill_attention"),
                 ("rwkv6_scan_kernel<", "rwkv6_scan"),
                 ("rwkv6_scan_bwd_kernel<", "rwkv6_scan_bwd"),
                 ("rwkv6_decode_kernel<", "rwkv6_scan"),
                 ("moe_gate_up_kernel<", "moe_experts"),
                 ("moe_down_kernel<", "moe_experts"))
_TEMPLATE_KEYS = {
    "void teola::split_kv_": (("teola::DenseKeys", "decode_attention"),
                              ("teola::PagedKeys", "verify_attention"),
                              ("teola::PagedDecodeKeys",
                               "paged_decode_attention")),
    "void teola::ft::flash_tile_kernel<": (
        ("teola::DenseKeys", "flash_prefill"),
        ("teola::ChunkPagedKeys", "chunk_prefill_attention"))}


def kernel_owner(key: str):
    """The kernel wrapper whose C entry point launches the kernel the
    profiler names ``key``, or None for any other kernel."""
    for prefix, policies in _TEMPLATE_KEYS.items():
        if key.startswith(prefix):
            for policy, owner in policies:
                if policy in key:
                    return owner
            return None
    for name, owner in _ANON_KERNELS:
        if key.startswith("void (anonymous namespace)::" + name):
            return owner
    return None


def _short(key: str) -> str:
    """A kernel's name without its return type, namespace and parameters."""
    k = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return k.split(">(")[0] + ">" if ">(" in k else k


@contextlib.contextmanager
def _scan_lengths():
    """While open, the sequence length of every K6 call the model makes, in
    order: the model's reference to the kernel wrapper is wrapped."""
    from repro_torch.models import ssm
    orig, lengths = ssm.rwkv6_scan, []

    def traced(r, *args, **kw):
        lengths.append(r.shape[1])
        return orig(r, *args, **kw)
    ssm.rwkv6_scan = traced
    try:
        yield lengths
    finally:
        ssm.rwkv6_scan = orig


def _k6_split(prof, lengths):
    """K6's device records in start order, matched one to one with its
    calls' sequence lengths: {"decode" (S = 1) or "prefill": (us, calls)},
    or None where the profiler kept another number of records than there
    were calls. Any tree's kernel is split the same way, whatever its
    kernels' names."""
    recs = sorted((start, us) for name, start, us in _device_records(prof)
                  if kernel_owner(name) == "rwkv6_scan")
    if len(recs) != len(lengths):
        return None
    split = {}
    for (_, us), n in zip(recs, lengths):
        ph = split.setdefault("decode" if n == 1 else "prefill", [0.0, 0])
        ph[0] += us
        ph[1] += 1
    return split


def _profiled_query(teola, docs, card: str, kernels):
    """One more query under torch.profiler: the card's busy share of the
    query's wall time, the kernels that take it, and per wrapper of
    ``kernels`` the device time of everything it launched per call (after
    the measured window, so the profiler's cost is not in the numbers
    above). Fails if a wrapper that launched in the query is charged no
    device time: its kernels' names would then be missing from
    kernel_owner."""
    from torch.profiler import ProfilerActivity, profile
    n0 = {fn.__name__: fn.launches for fn in kernels}
    with _scan_lengths() as lengths, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _, ctx = teola.query({"question": "what is fact 5 about optics",
                              "docs": docs}, timeout=600)
        torch.cuda.synchronize()
        wall = time.time() - t0
        t1 = time.time()
    if ctx.error is not None:
        raise ctx.error
    calls = {fn.__name__: fn.launches - n0[fn.__name__] for fn in kernels}
    evs = _device_rows(prof)
    dev_s = sum(t for _, t, _ in evs) / 1e6
    if dev_s <= 0:
        print("[profile] device time: not measured (the profiler saw no "
              "device activity)")
        return
    print(f"[profile] one query under the profiler: wall {wall:.3f} s, "
          f"device busy {dev_s:.3f} s ({100 * dev_s / wall:.1f}%), "
          f"{sum(n for _, _, n in evs)} device records read in "
          f"{time.time() - t1:.1f} s [{card}]")
    for t, key, _ in sorted(((t, k, n) for k, t, n in evs), reverse=True)[:8]:
        print(f"[profile]   {t / 1e3:9.3f} ms  {key[:90]}")
    mine = {}
    for key, t, n in evs:
        owner = kernel_owner(key)
        if owner is not None and t > 0:
            mine.setdefault(owner, []).append((t, n, key))
    for owner, rows in sorted(mine.items()):
        total = sum(t for t, _, _ in rows)
        n_calls = calls.get(owner, 0)
        each = (f"{total / n_calls:.2f} us per wrapper call"
                if n_calls else "wrapper calls not counted")
        parts = "; ".join(f"{_short(key)} {t / 1e3:.3f} ms over {n}"
                          for t, n, key in sorted(rows, reverse=True))
        print(f"[profile]   hand-written {owner}: {total / 1e3:.3f} ms device"
              f" over {n_calls} wrapper calls ({each}) [{card}]; kernels: "
              f"{parts}")
        if owner == "rwkv6_scan":
            split = _k6_split(prof, lengths)
            print("[profile]   rwkv6_scan by call: " + (
                "; ".join(f"{ph} {t / 1e3:.3f} ms over {n} calls "
                          f"({t / n:.2f} us each)"
                          for ph, (t, n) in sorted(split.items()))
                if split else f"not split ({sum(n for _, n, _ in rows)} "
                f"device records for {len(lengths)} calls)") + f" [{card}]")
    missed = [name for name, n in calls.items() if n > 0 and name not in mine]
    if missed:
        raise AssertionError(f"{missed} launched in the profiled query but "
                             f"no device time is charged to them")


def _warm_up(teola, docs):
    """1 warm-up query; returns (its seconds, its answer)."""
    t0 = time.time()
    _, ctx = teola.query({"question": "what is fact 1 about optics",
                          "docs": docs}, timeout=600)
    if ctx.error is not None:
        raise ctx.error
    return time.time() - t0, ctx.store.get("answer")


def _run_window(teola, docs):
    """The 4 questions submitted together, with the port's tracer on.
    Returns (window seconds, contexts, each engine's busy seconds in the
    window: the union of its ``batch`` and ``llm.*`` spans)."""
    tracing.enable()
    try:
        t0 = time.time()
        ctxs = [teola.submit({"question": q, "docs": docs})
                for q in QUESTIONS]
        for c in ctxs:
            if not c.done.wait(600):
                raise TimeoutError("serve query timed out")
        wall = time.time() - t0
    finally:
        tracing.disable()
    torch.cuda.synchronize()
    return wall, ctxs, tracing.busy_seconds(tracing.drain()["records"])


def _check_answers(ctxs) -> list:
    answers = []
    for c in ctxs:
        if c.error is not None:
            raise c.error
        ans = c.store.get("answer")
        if not isinstance(ans, str) or not ans:
            raise AssertionError(f"empty answer for {c.qid}: {ans!r}")
        answers.append(ans)
    return answers


def _layers(engines) -> int:
    return replicas_of(engines["core_llm"])[0].cfg.num_layers


def _print_window(tag, warm, wall, ctxs, dec, busy, launches, card,
                  optional=()):
    """The window's lines; fails if a kernel of ``launches`` not named in
    ``optional`` was launched no time."""
    nq = 1 + len(QUESTIONS)
    print(f"[{tag}] warm-up query {warm:.3f} s [{card}]")
    for c in ctxs:
        print(f"[{tag}] {c.qid}: latency {c.latency:.3f} s, answer "
              f"{len(c.store['answer'].split())} words [{card}]")
    print(f"[{tag}] 4 queries in {wall:.3f} s; decode {dec} tokens, "
          f"{dec / wall:.1f} tokens/s over the window [{card}]")
    print(f"[{tag}] engine busy seconds in the window (its spans): " +
          ", ".join(f"{k} {v:.3f}" for k, v in busy.items()))
    print(f"[{tag}] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    print(f"[{tag}] kernel launches on this path ({nq} queries): "
          + ", ".join(f"{k} {n} ({n / nq:.1f} per query)"
                      for k, n in launches.items()))
    for name, n in launches.items():
        if n <= 0 and name not in optional:
            raise AssertionError(f"{name} was not launched on the {tag} "
                                 f"path")


def phase_serve(dev, card: str, model="tinyllama-1.1b",
                kernels=(flash_prefill, decode_attention), tag="serve",
                on_core=None):
    """A dense path: naive-RAG under Teola with ``model`` as the core LLM,
    its KV or recurrent state in the dense cache, through ``kernels``
    (``on_core(core)`` runs after the profiled query, while the engine
    lives). Returns (launches, answers: the warm-up query's, then the
    window's)."""
    torch.cuda.reset_peak_memory_stats()
    engines = build_engines(device=dev)
    core = LLMEngine("core_llm", get_config(model), seed=SEED, max_batch=4,
                     device=dev)
    engines["core_llm"] = core
    teola = Teola(naive_rag(engines), engines)
    docs = doc_corpus(2)
    try:
        for fn in kernels:
            fn.launches = 0
        warm, warm_answer = _warm_up(teola, docs)
        dec0 = core.stats["decode_tokens"]
        wall, ctxs, busy = _run_window(teola, docs)
        launches = {fn.__name__: fn.launches for fn in kernels}
        stats = dict(core.stats)
        dec = stats["decode_tokens"] - dec0
        _profiled_query(teola, docs, card, kernels)
        if on_core is not None:
            on_core(core)
    finally:
        teola.shutdown()
    answers = [warm_answer] + _check_answers(ctxs)
    kinds = {sp.kind for st in core.cfg.stages for sp in st.pattern}
    held = {"rwkv": "recurrent state", "hybrid": "KV + Mamba state"}
    print(f"[{tag}] core_llm {model}, {_layers(engines)} layers, "
          f"fp32 weights, dense {held.get(kinds.pop(), 'KV')}; prefilled "
          f"{stats['prefill_tokens']} and decoded {stats['decode_tokens']} "
          f"tokens over the {1 + len(QUESTIONS)} queries")
    _print_window(tag, warm, wall, ctxs, dec, busy, launches, card)
    return launches, answers


def phase_serve_paged(dev, card: str, dense_answers,
                      model="tinyllama-1.1b", tag="paged", after=None,
                      optional=()):
    """The paged path: paged KV + radix cache, chunked prefill, k=3
    prompt-lookup speculation, continuous batching. ``after(core,
    answers)`` runs at the end, the runtime shut down and the engine's
    weights still on the card. A kernel named in ``optional`` may go
    unlaunched in the window (K4 runs only where speculation finds no
    draft). Returns launches."""
    torch.cuda.reset_peak_memory_stats()
    opts = dict(paged_kv=True, chunked_prefill=True, prefill_chunk=128,
                prefix_cache="radix")
    engines = build_engines(device=dev, **opts)
    core = LLMEngine("core_llm", get_config(model), seed=SEED,
                     max_batch=4, device=dev, paged=True,
                     chunked_prefill=True, prefill_chunk=128,
                     prefix_cache="radix")
    core.enable_speculative(draft=None, k=3)
    engines["core_llm"] = core
    teola = Teola(naive_rag(engines), engines, continuous_batching=True)
    docs = doc_corpus(2)
    try:
        for fn in PAGED:
            fn.launches = 0
        warm, warm_answer = _warm_up(teola, docs)
        dec0 = core.stats["decode_tokens"]
        wall, ctxs, busy = _run_window(teola, docs)
        launches = {fn.__name__: fn.launches for fn in PAGED}
        dec = core.stats["decode_tokens"] - dec0
        spec = dict(core.spec.stats)
        radix = dict(core.radix.stats)
        _profiled_query(teola, docs, card, PAGED)
    finally:
        teola.shutdown()
    answers = [warm_answer] + _check_answers(ctxs)
    # every sequence released (the runtime releases after marking a
    # query done): no block held but the radix tree's
    t0 = time.time()
    while core.states and time.time() - t0 < 10:
        time.sleep(0.01)
    held = core.radix.num_blocks()
    audit = core.alloc.audit()
    if core.states or core.alloc.free_blocks() != \
            core.alloc.capacity - held or not audit["ok"]:
        raise AssertionError(
            f"paged pool leaked: {len(core.states)} sequences resident, "
            f"{core.alloc.free_blocks()} free of {core.alloc.capacity} "
            f"with {held} radix-held, audit {audit}")
    print(f"[{tag}] core_llm {model}, {_layers(engines)} layers, "
          f"fp32 weights, paged KV {core.num_blocks}x{core.block_size} + "
          f"radix cache, chunked "
          f"prefill 128, prompt-lookup speculation k=3, continuous batching")
    _print_window(tag, warm, wall, ctxs, dec, busy, launches, card,
                  optional)
    acc = spec["tokens_emitted"] / max(1, spec["seq_steps"])
    print(f"[{tag}] radix: {radix['hit_tokens']} prefill tokens served from "
          f"cache ({radix['hits']} hits, {radix['misses']} misses); "
          f"speculation: {spec['accepted']} of {spec['drafted']} drafted "
          f"tokens accepted, {acc:.2f} tokens per sequence step, "
          f"{spec['target_steps']} verify + {spec['fallback_steps']} "
          f"single-token target steps [{card}]")
    print(f"[{tag}] pool after release: {core.alloc.free_blocks()} of "
          f"{core.alloc.capacity} blocks free, {held} held by the radix "
          f"tree, 0 leaked, audit ok")
    same = sum(a == b for a, b in zip(answers, dense_answers))
    print(f"[{tag}] {same} of {len(answers)} answers (the warm-up query's "
          f"and the window's) equal the dense path's token for token "
          f"(printed only: the paths batch tokens in other groupings and "
          f"the kernels sum in other orders)")
    if after is not None:
        after(core, answers)
    return launches


# ---------------------------------------------------------------------------
# phase 7: RWKV-6 (K6, the 2-layer model, the serve path)

RWKV = "rwkv6-3b"
# K6 against its plain version: fp32 inputs differ only in summation order
# over hd terms per step; bf16 inputs are the same bf16 values on both
# sides, held at the bf16 level of the other kernels
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# a two-chunk prefill against one chunk on the card: the same recurrence,
# the projections' matmuls may sum in another order for other row counts
SPLIT_TOL = 1e-3


def _scan_case(B, S, H, hd, dev, dtype):
    """tests/test_kernels.py's distributions: r, k, v ~ N(0, 0.25), w in
    (0.4, 0.9), a nonzero u and a random state0."""
    rs = np.random.RandomState(B * 1000 + S + hd)

    def randn(*shape):
        return torch.from_numpy(rs.standard_normal(shape).astype(
            np.float32)).to(dev)
    r, k, v = [randn(B, S, H, hd) * 0.5 for _ in range(3)]
    w = torch.sigmoid(randn(B, S, H, hd)) * 0.5 + 0.4
    return [a.to(dtype) for a in (r, k, v, w)] + [randn(H, hd) * 0.1,
                                                  randn(B, H, hd, hd) * 0.1]


# fp32 operations per state element and step (a multiply-add counts 2):
# 7 as K6's bound has counted them since its first port (k*v, u*kv, the
# add, r*(...) and w*S + kv as multiply-adds), kept so that its rows stay
# comparable; 5 that the recurrence needs, its bonus term taken out of the
# sum (k*v, then w*S + kv and r*S as multiply-adds)
SCAN_OPS, SCAN_OPS_NEEDED = 7, 5


def _scan_work(r, ops: int = SCAN_OPS):
    """Bytes (r, k, v, w in, y out, the state in and out) and flops
    (``ops`` * hd^2 per (b, t, h)) of one K6 call."""
    B, S, H, hd = r.shape
    nbytes = (4 * r.numel() * r.element_size() + r.numel() * 4
              + 2 * B * H * hd * hd * 4)
    return nbytes, ops * hd * hd * B * S * H


K6_LAYERS = 32                        # RWKV-6 3B's layers: one state each


def k6_cold_warm(scan, dev):
    """Device ms of one K6 decode step (B=4, S=1, RWKV-6 3B's heads, fp32),
    each call writing its state in place as the model does: cold, walking
    K6_LAYERS distinct states one call each as the model walks its layers
    (84 MB of state, more than the 50 MB L2, so each call finds its state
    in device memory), and warm, one state called again and again (in L2).
    None where the profiler saw nothing."""
    xs = [_scan_case(4, 1, 40, 64, dev, torch.float32)
          for _ in range(K6_LAYERS)]

    def walk():
        for x in xs:
            scan(*x, out_state=x[5])
    cold = device_ms(walk)
    return (None if cold is None else cold / K6_LAYERS,
            device_ms(lambda: scan(*xs[0], out_state=xs[0][5])))


def phase_rwkv_kernel(dev) -> dict:
    """K6 against its plain version (y and the final state), then timed
    at the serve path's shapes, and its decode step cold and warm. Returns
    {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms,
    cold_device_ms} at the decode shape (B=4, S=1), the one the serve
    path launches most."""
    res = {"max_abs_err": 0.0}
    cases = [(4, S, 40, 64) for S in (512, 128, 1)] + [(4, 128, 80, 32)]
    for B, S, H, hd in cases:
        for dtype in (torch.float32, torch.bfloat16):
            xs = _scan_case(B, S, H, hd, dev, dtype)
            y, st = rwkv6_scan(*xs)
            torch.cuda.synchronize()
            y_p, st_p = rwkv6_scan_plain(*xs)
            err = max((y - y_p).abs().max().item(),
                      (st - st_p).abs().max().item())
            tol = SCAN_TOL[dtype]
            print(f"[rwkv] rwkv6_scan B={B} S={S} H={H} hd={hd} "
                  f"{str(dtype)[6:]}: max_abs_err (y, state) {err:.3e} "
                  f"(tolerance {tol:g})")
            if not (err <= tol):
                raise AssertionError(f"rwkv6_scan: {err} > {tol}")
            res["max_abs_err"] = max(res["max_abs_err"], err)
    # timings at RWKV-6 3B's heads, batch bucket 4: the largest prefill
    # bucket, the serve path's prefill buckets (128, 64), then decode
    # (reported)
    for S in (512, 128, 64, 1):
        xs = _scan_case(4, S, 40, 64, dev, torch.float32)
        ms = cuda_ms(lambda: rwkv6_scan(*xs))
        dev_ms = device_ms(lambda: rwkv6_scan(*xs))
        plain = cuda_ms(lambda: rwkv6_scan_plain(*xs), iters=5, warmup=1)
        bound, by = _bound(*_scan_work(xs[0]))
        need, need_by = _bound(*_scan_work(xs[0], SCAN_OPS_NEEDED))
        print(f"[rwkv] rwkv6_scan B=4 S={S} H=40 hd=64 fp32: kernel "
              f"{ms:.4f} ms (device {_fmt(dev_ms)}), plain {plain:.4f} ms, "
              f"bound {bound:.4f} ms ({by}, {SCAN_OPS}*hd^2 per step), "
              f"{need:.4f} ms ({need_by}) at the {SCAN_OPS_NEEDED}*hd^2 the "
              f"recurrence needs; no single PyTorch call computes the "
              f"recurrence")
        res.update(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound,
                   bound_by=by, needed_bound_ms=need, library_ms=None,
                   library_device_ms=None)
    cold, warm = k6_cold_warm(rwkv6_scan, dev)
    print(f"[rwkv] rwkv6_scan decode step B=4 S=1 H=40 hd=64 fp32, state "
          f"written in place: cold {_fmt(cold)} per call over "
          f"{K6_LAYERS} states ({K6_LAYERS} x 2.6 MB, more than the L2), "
          f"warm {_fmt(warm)} (one state, in L2), bound {res['bound_ms']:.4f}"
          f" ms ({res['bound_by']})")
    res["cold_device_ms"] = cold
    return res


def _state_leaves(cache):
    """The recurrent cache's leaves (state, sx_tm, sx_cm), on the CPU."""
    return {k: v.float().cpu() for k, v in cache["stages"][0][0].items()}


def phase_rwkv_model(dev):
    """RWKV-6 3B at full width, 2 layers, card against CPU on the same
    weights: prefill 100 tokens then 8 decode steps (logits and every
    layer's state and token-shift rows), one K6 launch per layer per
    forward, and a prefill in two chunks against one."""
    cfg = two_layer(RWKV)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params_cpu = init_params(cfg, gen, torch.float32, "cpu")
    params_dev = tree_to(params_cpu, dev)
    toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size, 108)
    sched = [(0, 100)] + [(100 + i, 101 + i) for i in range(8)]
    n0 = rwkv6_scan.launches
    got, got_c = run_model(cfg, params_dev, dev, toks, sched=sched)
    torch.cuda.synchronize()
    n = rwkv6_scan.launches - n0
    if n != 2 * len(sched):
        raise AssertionError(f"rwkv model phase launched K6 {n} times, "
                             f"expected {2 * len(sched)}")
    want, want_c = run_model(cfg, params_cpu, "cpu", toks, sched=sched)
    got_c, want_c = _state_leaves(got_c), _state_leaves(want_c)
    err = _max_err(got, want)
    err_c = max((got_c[k] - want_c[k]).abs().max().item() for k in want_c)
    scale = max(w.abs().max().item() for w in want)
    finite = all(torch.isfinite(g).all().item() for g in got)
    split_c, one_c = [
        _state_leaves(run_model(cfg, params_dev, dev, toks, sched=sc)[1])
        for sc in ([(0, 37), (37, 100)], [(0, 100)])]
    err_s = max((split_c[k] - one_c[k]).abs().max().item() for k in one_c)
    hd = cfg.ssm.head_dim
    print(f"[rwkv] {cfg.name} (d={cfg.d_model}, H={cfg.d_model // hd}, "
          f"hd={hd}, 2 layers): card vs CPU max |dlogits| {err:.3e} over "
          f"|logits| <= {scale:.3f}, max |dcache| (state, sx_tm, sx_cm) "
          f"{err_c:.3e} (tolerance {MODEL_TOL:g}); K6 launches {n} "
          f"(2 layers x {len(sched)} forwards); prefill 37 + 63 vs 100 "
          f"on the card: max |dcache| {err_s:.3e} (tolerance "
          f"{SPLIT_TOL:g})")
    if not finite or not (max(err, err_c) <= MODEL_TOL) or \
            not (err_s <= SPLIT_TOL):
        raise AssertionError(f"rwkv model phase: {err}, {err_c}, {err_s}, "
                             f"finite {finite}")


# ---------------------------------------------------------------------------
# phase 8: the other architectures at full width, 2 layers ([archs])

# (model, also on the paged pool): each configuration's first stage at full
# width, cut to 2 layers; DeepSeek-V3's is its dense-FFN stage (one of its
# MoE layers alone holds 45 GB of fp32 experts)
ARCHS = [("qwen2-moe-a2.7b", True), ("deepseek-v3-671b", True),
         ("hymba-1.5b", False), ("chatglm3-6b", False),
         ("deepseek-67b", False), ("musicgen-medium", False),
         ("internvl2-26b", False), ("gemma2-9b", True)]
# a top-k choice that differs between the card and the CPU must come from
# a near-tie: float32 sums in another order move a probability by ~1e-7
FLIP_GAP = 1e-5


@contextlib.contextmanager
def _routing(replay=None):
    """While open, every MoE router call's own top-k choices and its
    probabilities' k-th and (k+1)-th values, on the CPU, in call order.
    With ``replay`` (the calls of another run), each call then takes that
    run's choices instead of its own, its gates read from its own
    probabilities at them: both runs follow one routing, so a near-tie
    that falls the other way on one device leaves no row uncompared."""
    from repro_torch.models import moe
    orig, calls = moe.router_probs, []

    def traced(cfg, w, x2d):
        gates, idx, logits = orig(cfg, w, x2d)
        probs = torch.softmax(logits, -1)
        top = torch.topk(probs, cfg.moe.top_k + 1, -1)
        calls.append((idx.cpu(), top.values[:, -2:].cpu()))
        if replay is not None:
            idx = replay[len(calls) - 1][0].to(idx.device)
            gates = probs.gather(-1, idx)
            if cfg.moe.norm_topk_prob:
                gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
        return gates, idx, logits
    moe.router_probs = traced
    try:
        yield calls
    finally:
        moe.router_probs = orig


def _flips(card_calls, cpu_calls, sched, layers):
    """[(position, layer, card set, CPU set, CPU gap)] of every row whose
    top-k set differs between the devices (batch 1; call i is forward
    i // layers, layer i % layers)."""
    rows = []
    for i, ((ci, _), (wi, wt)) in enumerate(zip(card_calls, cpu_calls)):
        lo, layer = sched[i // layers][0], i % layers
        for r in range(ci.shape[0]):
            a, b = set(ci[r].tolist()), set(wi[r].tolist())
            if a != b:
                rows.append((lo + r, layer, a, b,
                             float(wt[r, 0] - wt[r, 1])))
    return rows


def phase_archs(dev, card: str):
    """Each configuration of ARCHS at full width, 2 layers, random fp32
    weights from SEED: prefill 100, Pass-3 partial prefill 40 and 8 decode
    steps on the card against the same code on the CPU (MODEL_TOL), fed
    tokens or, where the frontend is stubbed, seeded embeddings; on the
    paged pool too where marked (a verify chunk at the end). K1/K2 (K3-K5
    on the pool) must launch wherever the attention is GQA over a linear
    cache. The CPU run replays the card's MoE top-k choices, so the
    logits are held at every row; each choice the CPU would have made
    otherwise is printed and must be a near-tie (FLIP_GAP)."""
    for name, paged in ARCHS:
        cfg = two_layer(name)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params_dev = init_params(cfg, gen, torch.float32, dev)
        params_cpu = tree_to(params_dev, "cpu")
        rs = np.random.RandomState(SEED)
        toks = rs.standard_normal((152, cfg.d_model)).astype(np.float32) \
            if cfg.embed_stub else rs.randint(0, cfg.vocab_size, 152)
        spec = cfg.stages[0].pattern[0]
        # a layer whose attention is GQA over a linear cache (Gemma-2's
        # global layers; its local ones keep a ring, plain attention)
        gqa_linear = cfg.attention_kind == "gqa" and any(
            sp.window is None for sp in cfg.stages[0].pattern)
        layers = cfg.num_layers if cfg.moe is not None and spec.moe else 0
        forms = [False, True] if paged else [False]
        for form in forms:
            sched = SCHED + ([(148, 152)] if form else [])
            kern = PAGED if form else [flash_prefill, decode_attention]
            n0 = [fn.launches for fn in kern]
            with _routing() as card_calls:
                got, _ = run_model(cfg, params_dev, dev, toks, paged=form,
                                   verify_tail=form)
            torch.cuda.synchronize()
            n = [fn.launches - k for fn, k in zip(kern, n0)]
            with _routing(card_calls) as cpu_calls:
                want, _ = run_model(cfg, params_cpu, "cpu", toks, paged=form,
                                    verify_tail=form)
            flips = _flips(card_calls, cpu_calls, sched, layers) \
                if layers else []
            err = _max_err(got, want)
            scale = max(w.abs().max().item() for w in want)
            finite = all(torch.isfinite(g).all().item() for g in got)
            names = [fn.__name__ for fn in kern]
            what = "paged pool" if form else "dense cache"
            print(f"[archs] {cfg.name} (d={cfg.d_model}, H={cfg.num_heads}, "
                  f"K={cfg.num_kv_heads}, {cfg.attention_kind}, "
                  f"{spec.kind}{', MoE' if spec.moe else ''}"
                  f"{', window' if spec.window else ''}, 2 layers) on the "
                  f"{what}: card vs CPU max |dlogits| {err:.3e} over "
                  f"|logits| <= {scale:.3f} (tolerance {MODEL_TOL:g}) at "
                  f"every row; launches " + ", ".join(
                      f"{k} {v}" for k, v in zip(names, n)) + f" [{card}]")
            for p, layer, a, b, gap in flips:
                print(f"[archs]   top-k flip at position {p}, layer {layer}:"
                      f" card {sorted(a)} vs CPU {sorted(b)}, CPU prob gap "
                      f"{gap:.3e} (the CPU run took the card's)")
            if layers:
                gaps = torch.cat([t[:, 0] - t[:, 1] for _, t in cpu_calls])
                print(f"[archs]   routing: {len(card_calls)} router calls, "
                      f"{len(flips)} rows with another top-{cfg.moe.top_k} "
                      f"set on the card; smallest CPU prob gap between the "
                      f"k-th and (k+1)-th expert {gaps.min().item():.3e}")
            bad = [f for f in flips if f[4] >= FLIP_GAP]
            if not finite or not (err <= MODEL_TOL) or bad:
                raise AssertionError(f"archs {cfg.name} {what}: err {err}, "
                                     f"finite {finite}, flips {bad}")
            if gqa_linear and min(n) <= 0:
                raise AssertionError(f"archs {cfg.name} {what}: launches "
                                     f"{dict(zip(names, n))}")
        del params_dev, params_cpu
        _free()


# ---------------------------------------------------------------------------
# phase 9: Qwen1.5-MoE-A2.7B whole as naive-RAG's core LLM ([moe])

QWEN = "qwen2-moe-a2.7b"
HYMBA = "hymba-1.5b"


def _layer0(tree):
    """The first layer's tensors of a stacked params subtree."""
    return {k: v[0] if torch.is_tensor(v) else _layer0(v)
            for k, v in tree.items()}


def _time_dispatch(card: str):
    """One Qwen MoE layer's routed dispatch, times the model's layers, at
    a decode step of the dense path's batch bucket (4 tokens) and at a k=3
    verify chunk of it (16 tokens), timed beside the reference's
    all-experts formulation on the same inputs; the bound is the selected
    experts' fp32 weight bytes over the card's memory rate. The engines
    step on threads of their own, whose host ranges the profiler does not
    record by default (and recording them all costs minutes of parsing),
    so the dispatch is timed here on the engine's own weights."""
    from repro_torch.models import moe

    def timed(core):
        cfg, L = core.cfg, core.cfg.num_layers
        p = _layer0(core.params["stages"][0][0]["moe"])
        d, f = cfg.d_model, cfg.moe.d_expert
        gen = torch.Generator(device=core.device).manual_seed(SEED)
        for T, what in ((4, "a decode step"), (16, "a k=3 verify chunk")):
            x = torch.randn((T, d), generator=gen, device=core.device)
            with torch.inference_mode():
                got, _ = moe.routed(cfg, p, x)
                want, _ = moe.routed_dense_plain(cfg, p, x)
                err = (got - want).abs().max().item() / \
                    max(1e-30, want.abs().max().item())
                experts = len(set(moe.router_probs(cfg, p["router"], x)[1]
                                  .flatten().tolist()))
                bound = experts * 3 * d * f * 4 / HBM_BYTES_PER_S * 1e3
                dev_ms = device_ms(lambda: moe.routed(cfg, p, x))
                plain_ms = device_ms(
                    lambda: moe.routed_dense_plain(cfg, p, x))
                wall_ms = cuda_ms(lambda: moe.routed(cfg, p, x))
                alone = moe.routed(cfg, p, x[:1])[0]
                apart = (got[:1] - alone).abs().max().item() / \
                    max(1e-30, alone.abs().max().item())
            path = "grouped" if T * cfg.moe.top_k <= \
                moe.GROUPED_MAX_ASSIGN else "sorted, one host sync a layer"
            print(f"[moe] MoE dispatch at {what} (batch 4, {T} tokens, "
                  f"{experts} distinct experts of {cfg.moe.num_experts}), "
                  f"x {L} layers: selected pairs device "
                  f"{_fmt(dev_ms and dev_ms * L)}, wall {wall_ms * L:.3f} "
                  f"ms ({path}); the reference's "
                  f"all-experts form device "
                  f"{_fmt(plain_ms and plain_ms * L)}; bound (the selected "
                  f"experts' fp32 weights at {HBM_BYTES_PER_S / 1e12:.2f} "
                  f"TB/s) {bound * L:.3f} ms; relative max |dout| against "
                  f"the all-experts form {err:.2e}; the first token's "
                  f"output alone against in this batch, relative max "
                  f"|dout| {apart:.2e} (the experts' slices change shape) "
                  f"[{card}]")
            if not err <= 1e-5:
                raise AssertionError(f"MoE dispatch vs all experts: {err}")
    return timed


def time_moe_experts(dev, card: str):
    """``--moe``: the grouped expert kernel at Qwen1.5-MoE-A2.7B's expert
    shapes (d 2048, f 1408, 60 experts, top 4, fp32), on one layer's
    weights drawn as the model draws them. At T = 1, 4 and 16: the kernel
    alone against its plain version (``cuda_ms``, ``device_ms``), within
    2e-5 of the output's scale, and its bound, the touched experts' three
    matrices at the card's memory rate. At T = 1 to 512: ``routed`` on
    each path (grouped: the kernel; sorted: the per-expert products and
    one host sync), ``cuda_ms`` per call (what a caller waits: the host's
    launches and the sync included) and device ms. New tokens at every T;
    the layer's expert weights (2.1 GB) do not fit the 50 MB L2."""
    from repro_torch.kernels import moe_experts as tmx
    from repro_torch.models import moe
    build.build_all(("moe_experts",))
    print("[moe-experts] ptxas:", " | ".join(
        ln.strip() for ln in build.build_log["moe_experts"]["ptxas"]
        .splitlines() if "registers" in ln or "spill" in ln))
    cfg = get_config(QWEN)
    mo, d = cfg.moe, cfg.d_model
    E, k, f = mo.num_experts, mo.top_k, mo.d_expert
    p = _layer0(moe.init_moe_params(torch.Generator(device=dev).manual_seed(
        SEED), cfg, torch.float32, dev, 1))
    weights = (p["w_gate"], p["w_up"], p["w_down"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = {}
    for T in (1, 4, 16, 64, 128, 256, 512):
        x = torch.randn((T, d), generator=gen, device=dev)
        with torch.inference_mode():
            gates, idx, _ = moe.router_probs(cfg, p["router"], x)
            order, offsets = moe._route(E, idx)
            experts = int((offsets.diff() > 0).sum())
            bound = experts * 3 * d * f * 4 / HBM_BYTES_PER_S * 1e3
            if T <= 16:
                args = (x, order, offsets, gates, *weights, cfg.act, k)
                got = tmx.moe_experts(*args)
                want = tmx.moe_experts_plain(*args)
                err = ((got - want).abs().max() /
                       want.abs().max()).item()
                if not err <= 2e-5:
                    raise AssertionError(f"moe_experts T={T}: {err}")
                n0 = tmx.moe_experts.launches
                ms = cuda_ms(lambda: tmx.moe_experts(*args))
                dev_ms = device_ms(lambda: tmx.moe_experts(*args))
                plain = cuda_ms(lambda: tmx.moe_experts_plain(*args))
                plain_dev = device_ms(lambda: tmx.moe_experts_plain(*args))
                calls = tmx.moe_experts.launches - n0
                print(f"[moe-experts] kernel T={T} ({experts} experts "
                      f"touched): ms {ms:.4f}, device {_fmt(dev_ms)}, per "
                      f"call {dev_ms * 1e3:.2f} us, bound {bound:.4f} ms "
                      f"(bytes), device/bound "
                      f"{dev_ms / bound:.2f}; plain ms {plain:.4f}, plain "
                      f"device {_fmt(plain_dev)}; relative max |dy| "
                      f"{err:.2e}; {calls} wrapper calls timed [{card}]")
                rows[T] = {"ms": ms, "device_ms": dev_ms, "bound_ms": bound,
                           "plain_ms": plain, "plain_device_ms": plain_dev}
            limit, paths = moe.GROUPED_MAX_ASSIGN, {}
            try:
                for path, lim in (("grouped", 1 << 30), ("sorted", 0)):
                    moe.GROUPED_MAX_ASSIGN = lim
                    paths[path] = (cuda_ms(lambda: moe.routed(cfg, p, x)),
                                   device_ms(lambda: moe.routed(cfg, p, x)))
            finally:
                moe.GROUPED_MAX_ASSIGN = limit
        (gw, gd), (sw, sd) = paths["grouped"], paths["sorted"]
        print(f"[moe-crossover] T={T} T*k={T * k} ({experts} experts "
              f"touched, bound {bound:.4f} ms): grouped ms {gw:.4f} device "
              f"{_fmt(gd)}; sorted ms {sw:.4f} device {_fmt(sd)}; "
              f"sorted/grouped {sw / gw:.2f} [{card}]")
        rows.setdefault(T, {}).update(grouped_ms=gw, grouped_device_ms=gd,
                                      sorted_ms=sw, sorted_device_ms=sd,
                                      experts=experts)
    L = cfg.num_layers
    print(f"[moe-experts] batch-4 decode step x {L} layers: kernel device "
          f"{rows[4]['device_ms'] * L:.3f} ms against the bound "
          f"{rows[4]['bound_ms'] * L:.3f} ms; routed grouped "
          f"{rows[4]['grouped_ms'] * L:.3f} ms a step (device "
          f"{rows[4]['grouped_device_ms'] * L:.3f}), sorted "
          f"{rows[4]['sorted_ms'] * L:.3f} ms (device "
          f"{rows[4]['sorted_device_ms'] * L:.3f}) [{card}]")
    print(json.dumps({"moe_experts": rows, "card": card}))


def _paged_vs_dense(card: str, tag: str = "moe"):
    """The engine's whole model, on its own weights, on a dense cache and on
    a paged pool read through a shuffled table, fed the same fixed tokens
    (run_model's schedule and a verify chunk at the end). Each form first
    takes its own routing: printed are where a top-k choice first differs
    between the two, its probability gap, and how many rows' greedy
    tokens agree before and from there. Then the paged form replays the
    dense form's routing and is held against it at every row within
    MODEL_TOL of the logits' scale: a fault of the paged path at depth
    shows there, and the answers of the two serve paths, which differ
    (printed by the paged phase), are read against this. A model without
    MoE has one routing: its paged form is run once."""
    def check(core):
        cfg, dev, L = core.cfg, core.device, core.cfg.num_layers
        toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size, 152)
        sched = SCHED + [(148, 152)]
        run = functools.partial(run_model, cfg, core.params, dev, toks,
                                verify_tail=True)
        with _routing() as dense_calls:
            dense, _ = run()
        with _routing() as paged_calls:
            own, _ = run(paged=True)
        paged = own
        if cfg.moe is not None:
            with _routing(dense_calls):
                paged, _ = run(paged=True)
        torch.cuda.synchronize()
        flips = _flips(dense_calls, paged_calls, sched, L)
        first = min(flips, default=None, key=lambda f: (f[0], f[1]))
        top = [torch.cat(o, 1)[0] for o in (dense, own)]
        agree = (top[0].argmax(-1) == top[1].argmax(-1)).tolist()
        cut = first[0] if first else len(agree)
        margin = torch.topk(top[0], 2, -1).values
        margin = (margin[:, 0] - margin[:, 1]).median().item()
        scale = max(o.abs().max().item() for o in dense)
        err = _max_err(paged, dense)
        finite = all(torch.isfinite(o).all().item() for o in paged + own)
        where = (f"position {first[0]}, layer {first[1]} (probability gap "
                 f"{first[4]:.3e})" if first else "no row")
        if cfg.moe is not None:
            print(f"[{tag}] depth check, {L} layers, 152 positions: on their"
                  f" own routings the dense and paged forms first choose "
                  f"other experts at {where}, {len(flips)} (row, layer) "
                  f"choices differ in all; greedy tokens agree at "
                  f"{sum(agree[:cut])} of {cut} rows before that and "
                  f"{sum(agree[cut:])} of {len(agree) - cut} from there "
                  f"(median top-1 margin {margin:.3f} over |logits| <= "
                  f"{scale:.3f}) [{card}]")
        else:
            print(f"[{tag}] depth check, {L} layers, 152 positions: greedy "
                  f"tokens of the dense and paged forms agree at "
                  f"{sum(agree)} of {len(agree)} rows (median top-1 margin "
                  f"{margin:.3f} over |logits| <= {scale:.3f}) [{card}]")
        how = " replaying the dense form's routing" if cfg.moe else ""
        print(f"[{tag}] depth check, the paged form{how}: max |dlogits| "
              f"{err:.3e} at every row over |logits| <= {scale:.3f} "
              f"(tolerance {MODEL_TOL:g} x {scale:.3f}) [{card}]")
        if not finite or not err <= MODEL_TOL * scale:
            raise AssertionError(f"paged vs dense at depth: err {err}, "
                                 f"scale {scale}, finite {finite}")
    return check


def _grouping(card: str, steps: int = 32):
    """The engine's whole model decoding greedily from a 100-token prompt
    on the dense cache, alone and as row 0 of a batch of 4 (three other
    seeded prompts): the same kernels and the same tokens in, only the
    grouping differs, as it does between the two serve paths (batch
    buckets, 4-token verify chunks, 128-token prefill chunks). Printed:
    how far the prompt's last logits differ, the step at which row 0's
    greedy tokens first part, and row 0's first top-k choice that
    differs between the two runs with its probability gap. Printed only:
    it reads why the paths' answers part."""
    def run(core, toks):
        cfg, dev = core.cfg, core.device
        B, S = toks.shape
        cache = kvc.init_cache(cfg, B, T, device=dev)
        out = []
        with _routing() as calls, torch.inference_mode():
            logits, cache = apply_model(cfg, core.params, torch.as_tensor(
                toks, device=dev), cache, 0)
            first = logits[0, -1].float().cpu()
            for i in range(steps):
                nxt = logits[:, -1].argmax(-1)
                out.append(int(nxt[0]))
                logits, cache = apply_model(cfg, core.params, nxt[:, None],
                                            cache, S + i)
        return out, calls, first

    def check(core):
        L, S = core.cfg.num_layers, 100
        toks = np.random.RandomState(SEED + 1).randint(
            0, core.cfg.vocab_size, (4, S))
        (alone, ca, la), (batch, cb, lb) = run(core, toks[:1]), \
            run(core, toks)
        part = next((i for i, (a, b) in enumerate(zip(alone, batch))
                     if a != b), None)
        where = "nowhere"
        for j, ((ia, ta), (ib, _)) in enumerate(zip(ca, cb)):
            step, layer = j // L - 1, j % L     # step -1: the prompt
            rows = [r for r in range(S if step < 0 else 1)
                    if set(ia[r].tolist()) != set(ib[r].tolist())]
            if rows:
                r = rows[0]
                at = f"prompt row {r}" if step < 0 else f"step {step}"
                where = (f"{at}, layer {layer}, probability gap "
                         f"{float(ta[r, 0] - ta[r, 1]):.3e}")
                break
        tokens = (f"agree at all {steps} steps" if part is None
                  else f"part at step {part} of {steps}")
        print(f"[moe] grouping check, {L} layers, greedy from a {S}-token "
              f"prompt alone and as row 0 of a batch of 4: the prompt's "
              f"last logits differ by {(la - lb).abs().max().item():.3e} "
              f"over |logits| <= {la.abs().max().item():.3f}; its tokens "
              f"{tokens}; its first top-k choice that differs: {where} "
              f"[{card}]")
    return check


def _assert_empty_card(tag: str):
    _free()
    used = torch.cuda.memory_allocated()
    print(f"[{tag}] memory_allocated before the engine: "
          f"{used / 2**30:.3f} GiB")
    if used >= 2 ** 30:
        raise AssertionError(f"{tag}: {used / 2**30:.2f} GiB still "
                             f"allocated before building the engine")


@contextlib.contextmanager
def _core_prompts():
    """While open, the text of every prefill task the core LLM is given
    (monolithic or chunked), in arrival order."""
    texts, orig = [], (LLMEngine.op_prefill, LLMEngine.submit_prefill)

    def op_prefill(self, task_batch):
        if self.name == "core_llm":
            texts.extend(t["text"] for t in task_batch)
        return orig[0](self, task_batch)

    def submit_prefill(self, task, on_done=None):
        if self.name == "core_llm":
            texts.append(task["text"])
        return orig[1](self, task, on_done)
    LLMEngine.op_prefill, LLMEngine.submit_prefill = op_prefill, \
        submit_prefill
    try:
        yield texts
    finally:
        LLMEngine.op_prefill, LLMEngine.submit_prefill = orig


def _compare_prompts(dense, paged, card: str, tag: str = "moe-paged"):
    """Prints how the core LLM's prompts on the two paths compare, as
    multisets: naive-RAG asks for one candidate answer per retrieved
    context, then combines the candidates in one more prompt, so a
    candidate that differs by one greedy token changes that prompt
    and the whole answer after it."""
    left = list(dense)
    for t in paged:
        if t in left:
            left.remove(t)
    rest = [t for t in paged if t not in dense]
    words = []
    for t in rest:
        near = max(left, key=lambda u: sum(
            a == b for a, b in zip(u.split(), t.split())), default="")
        pairs = list(zip(near.split(), t.split()))
        words.append(f"{sum(a != b for a, b in pairs)} of {len(pairs)}")
    print(f"[{tag}] core LLM prompts: {len(paged) - len(rest)} of "
          f"{len(paged)} equal to the dense path's; the {len(rest)} others "
          f"begin " + ", ".join(sorted({repr(' '.join(t.split()[:2]))
                                        for t in rest}))
          + "; words differing from the nearest dense prompt: "
          + ", ".join(words) + f" [{card}]")


def phase_moe(dev, card: str) -> dict:
    """Naive-RAG under Teola with the full 24-layer Qwen1.5-MoE-A2.7B
    (53.3 GiB of fp32 weights) as the core LLM: the dense path (K1, K2),
    then, that engine freed, the paged path (K3, K4, K5). Never two Qwen
    engines at once. Returns the launches per path."""
    out = {}
    _assert_empty_card("moe")
    checks = (_time_dispatch(card), _paged_vs_dense(card), _grouping(card))
    with _core_prompts() as dense_prompts, \
            _core_generations() as dense_gens:
        out["dense"], answers = phase_serve(
            dev, card, QWEN, (flash_prefill, decode_attention), "moe",
            lambda core: [check(core) for check in checks])
    _assert_empty_card("moe-paged")
    with _core_prompts() as paged_prompts, \
            _core_generations() as paged_gens:
        out["paged"] = phase_serve_paged(
            dev, card, answers, QWEN, "moe-paged",
            _trace_parting(card, "moe-paged", answers, dense_gens,
                           paged_gens))
    _compare_prompts(dense_prompts, paged_prompts, card)
    return out


@contextlib.contextmanager
def _core_generations():
    """While open, every generation of the core LLM as (context token ids,
    generated token ids, text), in the order the generations end: the
    context is what the sequence's prefills wrote (a forked prefix, a
    partial prefill and its continuation) and the token its prefill
    chose, the ids what greedy decoding emitted after that token
    (monolithic op_decode or the continuous loop), the text what the
    engine returned for them."""
    gens, ctx, lock = [], {}, threading.Lock()
    orig = (LLMEngine._prepare_prefill_task, LLMEngine.decode_batch,
            LLMEngine.op_decode, LLMEngine.submit_decode)
    outs = threading.local()

    def prepare(self, t):
        fresh = t["sid"] not in self.states
        st, out, ptoks = orig[0](self, t)
        if self.name == "core_llm":
            with lock:
                prev = [] if fresh else ctx.get(t["sid"], [])
                ctx[t["sid"]] = prev + list(ptoks) + list(out)
        return st, out, ptoks

    def decode_batch(self, items, on_chunk=None):
        outs.ids = orig[1](self, items, on_chunk)
        return outs.ids

    def fed(self, sid):
        """The context and the token the prefill chose, which the decode
        feeds first (its ids are the tokens after it)."""
        with lock:
            return ctx.get(sid, []) + [int(self.states[sid].last_token)]

    def op_decode(self, task_batch, on_chunk=None):
        first = [fed(self, t["sid"]) for t in task_batch]
        texts = orig[2](self, task_batch, on_chunk)
        if self.name == "core_llm":
            with lock:
                for c, ids, text in zip(first, outs.ids, texts):
                    gens.append((c, [int(i) for i in ids], text))
        return texts

    def submit_decode(self, sid, max_new, on_text=None, on_done=None,
                      slo=None):
        first = fed(self, sid)

        def done(seq):
            if self.name == "core_llm":
                with lock:
                    gens.append((first, [int(i) for i in seq.tokens],
                                 seq.result))
            if on_done is not None:
                on_done(seq)
        return orig[3](self, sid, max_new, on_text, done, slo)
    (LLMEngine._prepare_prefill_task, LLMEngine.decode_batch,
     LLMEngine.op_decode, LLMEngine.submit_decode) = (
        prepare, decode_batch, op_decode, submit_decode)
    try:
        yield gens
    finally:
        (LLMEngine._prepare_prefill_task, LLMEngine.decode_batch,
         LLMEngine.op_decode, LLMEngine.submit_decode) = orig


def _last_row(core, toks, paged):
    """The whole model's logits at the last of ``toks`` (one prefill on a
    dense cache, or on a paged pool through a shuffled table), and each
    MoE router call's probability gap between its k-th and (k+1)-th
    expert at that row."""
    cfg, dev = core.cfg, core.device
    x = torch.as_tensor(np.asarray(toks)[None], device=dev)
    kw = {}
    if paged:
        cache = kvc.init_paged_pool(cfg, 1 + T // BS, BS, device=dev)
        table = np.random.RandomState(SEED).permutation(
            np.arange(1, 1 + T // BS))[None]
        kw["block_tables"] = torch.tensor(table, dtype=torch.int32,
                                          device=dev)
    else:
        cache = kvc.init_cache(cfg, 1, T, device=dev)
    with _routing() as calls, torch.inference_mode():
        logits, _ = apply_model(cfg, core.params, x, cache, 0, **kw)
    gaps = [float(t[-1, 0] - t[-1, 1]) for _, t in calls]
    return logits[0, -1].float().cpu(), gaps, [set(i[-1].tolist())
                                               for i, _ in calls]


def _trace_parting(card: str, tag: str, dense_answers, dense_gens,
                   paged_gens):
    """After the paged path: the first answer that differs between the
    dense and the paged path, traced through the core LLM's generations
    whose context both paths wrote alike. Printed: how many of those emit
    other token ids, and how many emit the same ids as other text (each
    engine's HashTokenizer decodes an id to the first word it encoded
    with that id, so its text follows the order of its encodes); for the
    first of each, where it parts. For the first that parts in its ids,
    the context plus the common tokens is replayed through the whole
    model (batch 1) on a dense cache and on a paged pool: the top-2 logit
    gap at that token on each form and, for an MoE model, the smallest
    top-k gate gap over the layers there. A parting in the ids is read as
    a fault only where that gate gap is not a near-tie (FLIP_GAP); it is
    printed either way."""
    def trace(core, paged_answers):
        first = next((i for i, (a, b) in enumerate(zip(dense_answers,
                                                       paged_answers))
                      if a != b), None)
        if first is None:
            print(f"[{tag}] parting: all {len(paged_answers)} answers equal "
                  f"the dense path's [{card}]")
            return
        dense = {}
        for c, ids, text in dense_gens:
            dense.setdefault(tuple(c), (ids, text))
        shared, by_ids, by_text = 0, [], []
        for c, ids, text in paged_gens:
            other = dense.get(tuple(c))
            if other is None:
                continue
            shared += 1
            if other[0] != ids:
                by_ids.append((list(c), other[0], ids))
            elif other[1] != text:
                by_text.append((ids, other[1], text))
        print(f"[{tag}] parting: answer {first} is the first of "
              f"{len(paged_answers)} to differ from the dense path's; of "
              f"{len(paged_gens)} core-LLM generations on this path, "
              f"{shared} have a context the dense path also wrote: "
              f"{len(by_ids)} of those emit other token ids, "
              f"{len(by_text)} the same ids as other text [{card}]")
        if by_text:
            ids, d_text, p_text = by_text[0]
            pairs = list(zip(d_text.split(), p_text.split()))
            w = next((n for n, (a, b) in enumerate(pairs) if a != b), None)
            if w is not None:
                print(f"[{tag}] parting: the first generation of the same "
                      f"{len(ids)} ids as other text reads word {w} as "
                      f"{pairs[w][0]!r} on the dense path and "
                      f"{pairs[w][1]!r} on the paged path [{card}]")
        if not by_ids:
            return
        c, d_ids, p_ids = by_ids[0]
        j = next((n for n, (a, b) in enumerate(zip(d_ids, p_ids)) if a != b),
                 None)
        if j is None:
            print(f"[{tag}] parting: the first generation that parts in its"
                  f" ids agrees on its first {min(len(d_ids), len(p_ids))} "
                  f"and differs in length ({len(d_ids)} dense, "
                  f"{len(p_ids)} paged) [{card}]")
            return
        toks = (c + d_ids[:j])[-T:]
        rows = {}
        for form in (False, True):
            logits, gaps, sets = _last_row(core, toks, form)
            top = torch.topk(logits, 2)
            rows[form] = (int(top.indices[0]), float(top.values[0]
                                                     - top.values[1]),
                          gaps, sets)
        print(f"[{tag}] parting: the first generation that parts in its "
              f"ids ({len(c)}-token context) diverges at generated token "
              f"{j}: dense path {d_ids[j]}, paged path {p_ids[j]}; replayed "
              f"at batch 1: dense form argmax {rows[False][0]} with top-2 "
              f"logit gap {rows[False][1]:.3e}, paged form argmax "
              f"{rows[True][0]} with top-2 logit gap {rows[True][1]:.3e} "
              f"[{card}]")
        gaps = rows[False][2] + rows[True][2]
        if gaps:
            low = min(gaps)
            tie = "a near-tie" if low < FLIP_GAP else "not a near-tie"
            same = rows[False][3] == rows[True][3]
            print(f"[{tag}] parting: top-k gate gap at that token, "
                  f"smallest over {len(rows[False][2])} layers and both "
                  f"forms {low:.3e} ({tie}, FLIP_GAP {FLIP_GAP:g}); the "
                  f"two forms choose {'the same' if same else 'other'} "
                  f"experts there [{card}]")
    return trace


@contextlib.contextmanager
def _head_dims():
    """While open, the attention kernel calls the model makes, counted by
    (kernel, head dim): the model's references to the five wrappers are
    wrapped."""
    from repro_torch.models import attention
    names = ("flash_prefill", "decode_attention", "paged_decode_attention",
             "verify_attention", "chunk_prefill_attention")
    orig = {n: getattr(attention, n) for n in names}
    counts, lock = {}, threading.Lock()

    def wrap(name, fn):
        def counted(q, *args, **kw):
            with lock:
                key = (name, q.shape[-1])
                counts[key] = counts.get(key, 0) + 1
            return fn(q, *args, **kw)
        return counted
    for n, fn in orig.items():
        setattr(attention, n, wrap(n, fn))
    try:
        yield counts
    finally:
        for n, fn in orig.items():
            setattr(attention, n, fn)


def _check_head_dim(tag: str, counts, kernels, hd: int):
    """Every kernel of ``kernels`` launched at head dim ``hd``."""
    print(f"[{tag}] attention kernel calls by head dim: " + ", ".join(
        f"{k} hd {h}: {n}" for (k, h), n in sorted(counts.items())))
    missing = [fn.__name__ for fn in kernels
               if counts.get((fn.__name__, hd), 0) <= 0]
    if missing:
        raise AssertionError(f"{tag}: {missing} not launched at hd {hd}")


GEMMA = "gemma2-9b"


def _model_size(card: str, tag: str):
    def show(core):
        n = sum(p.numel() for p in tree_leaves(core.params))
        nbytes = sum(p.numel() * p.element_size()
                     for p in tree_leaves(core.params))
        print(f"[{tag}] core_llm {core.cfg.name}: {n} parameters, "
              f"{nbytes / 2**30:.2f} GiB of fp32 weights drawn on the card "
              f"from seed {SEED}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"[{card}]")
    return show


def _decode_step(card: str, tag: str, pos: int = 256, steps: int = 8):
    """The core LLM's whole-model decode step on the engine's weights, a
    dense cache at ``pos`` tokens, batch 1 and 4: wall ms per step after
    2 warm-up steps (host clock around ``steps`` steps ending in a
    synchronize), kept for [cost]."""
    def run(core):
        cfg = core.cfg
        for B in (1, 4):
            cache = kvc.init_cache(cfg, B, T, device=core.device)
            x = torch.zeros((B, 1), dtype=torch.long, device=core.device)
            with torch.inference_mode():
                for i in range(2 + steps):
                    if i == 2:
                        torch.cuda.synchronize()
                        t0 = time.time()
                    apply_model(cfg, core.params, x, cache, pos + i)
                torch.cuda.synchronize()
            ms = 1e3 * (time.time() - t0) / steps
            MEASURED[f"{tag} decode B={B}"] = (cfg, InputShape(
                "decode", pos + steps, B, "decode"), ms)
            print(f"[{tag}] whole-model decode step, batch {B}, cache "
                  f"{pos}-{pos + steps}: {ms:.2f} ms [{card}]")
            del cache
    return run


def phase_gemma(dev, card: str) -> dict:
    """Naive-RAG under Teola with the whole 42-layer Gemma-2 9B (hd 256,
    logit softcap 50, local 4096-token windows on every other layer) as
    the core LLM: the dense path (K1 and K2 on the 21 global layers; the
    local layers keep a ring, plain masked attention, as in the
    reference), then, that engine freed, the paged path (K5, K3 and K4 on
    every layer, window and cap passed; K4 runs in the window only where
    speculation finds no draft, and in the depth check's decode steps).
    Never two Gemma engines at once. Every attention call at hd 256; the
    whole model's paged form held to its dense form; the first parting
    answer traced. Returns the launches per path."""
    out = {}
    _assert_empty_card("gemma")
    with _core_prompts() as dense_prompts, \
            _core_generations() as dense_gens, _head_dims() as dense_hd:
        out["dense"], answers = phase_serve(
            dev, card, GEMMA, DENSE, "gemma", lambda core: [
                _model_size(card, "gemma")(core),
                _decode_step(card, "gemma")(core)])
    _check_head_dim("gemma", dense_hd, DENSE, 256)
    _assert_empty_card("gemma-paged")
    # the paged engine's weights are the dense engine's (one seed): the
    # depth check runs both forms on them, K4 among them (8 decode steps)
    with _core_prompts() as paged_prompts, \
            _core_generations() as paged_gens, _head_dims() as paged_hd:
        out["paged"] = phase_serve_paged(
            dev, card, answers, GEMMA, "gemma-paged",
            lambda core, paged_answers: [
                _model_size(card, "gemma-paged")(core),
                _trace_parting(card, "gemma-paged", answers, dense_gens,
                               paged_gens)(core, paged_answers),
                _paged_vs_dense(card, "gemma-paged")(core)],
            optional=("paged_decode_attention",))
    _check_head_dim("gemma-paged", paged_hd, PAGED, 256)
    _compare_prompts(dense_prompts, paged_prompts, card, "gemma-paged")
    return out


# ---------------------------------------------------------------------------
# phase 10: Hymba-1.5B whole as naive-RAG's core LLM ([hybrid])

def _time_mamba(card: str):
    """One Hymba layer's Mamba branch, times the model's layers, at a
    decode step (batch 4) and at a 512-token prefill bucket (batch 4): the
    step loop launches once per token."""
    from repro_torch.models import ssm

    def timed(core):
        cfg, L = core.cfg, core.cfg.num_layers
        p = _layer0(core.params["stages"][0][0]["mamba"])
        d, s = cfg.d_model, cfg.ssm
        gen = torch.Generator(device=core.device).manual_seed(SEED)
        h = torch.zeros((4, d, s.state_dim), device=core.device)
        c = torch.zeros((4, s.conv_dim - 1, d), device=core.device)
        for S, iters in ((1, 20), (512, 3)):
            x = torch.randn((4, S, d), generator=gen, device=core.device)
            with torch.inference_mode():
                run = lambda: ssm.mamba_branch(cfg, p, x, h, c)  # noqa: E731
                dev_ms = device_ms(run, iters=iters, warmup=1)
                wall_ms = cuda_ms(run, iters=iters, warmup=1)
            print(f"[hybrid] Mamba branch at S={S} (batch 4), x {L} layers:"
                  f" device {_fmt(dev_ms and dev_ms * L)}, wall "
                  f"{wall_ms * L:.3f} ms [{card}]")
    return timed


def phase_hybrid(dev, card: str):
    """Naive-RAG under Teola with the full 32-layer Hymba-1.5B as the core
    LLM on the dense path: windowed attention (the ring buffer, plain
    attention on every device) and the Mamba branch's step loop."""
    _assert_empty_card("hybrid")
    phase_serve(dev, card, HYMBA, (), "hybrid", _time_mamba(card))


# ---------------------------------------------------------------------------
# phase 11: training ([train])

# K6 backward against autograd through the plain recurrence on the card,
# each gradient's max |difference| over its largest magnitude: float32
# inputs differ only in summation order (per step sums of hd terms, du over
# every step); bf16 inputs get bf16 gradients on both sides, which may
# round one bf16 step apart (2^-8 of a value)
K6_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# a train step at full width, 2 layers, card against CPU: the loss
# relative, each gradient leaf's max |difference| over its largest
# magnitude, and gnorm relative (TF32 off: float32 products in another
# order on each device); the new params: Adam's first step is lr * g /
# (|g| + eps), about lr * sign(g), so an entry whose gradient is within the
# gradient tolerance of 0 may take the other sign (2 lr apart); one ten
# times above it (FIRM of its leaf's largest) is held at 5% of lr
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_GNORM_TOL = 1e-4, 1e-3, 1e-4
TRAIN_FIRM = 10 * TRAIN_GRAD_TOL
# the models held card against CPU ([train] b) and the others that take
# TRAIN_STEPS steps on the card; B x S tokens each
TRAIN_HELD = ("tinyllama-1.1b", "rwkv6-3b", "qwen2-moe-a2.7b", "hymba-1.5b")
TRAIN_OTHERS = ("deepseek-v3-671b", "chatglm3-6b", "deepseek-67b",
                "gemma2-9b", "musicgen-medium", "internvl2-26b")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 100, 3
# fp32 operations per state element and step of K6's backward: the state
# recomputed (k*v and w*S + kv, 3), the sums of dr, dk, dw and dv (a
# multiply-add each, 8) and the dS update (r*dy and w*dS + r dy, 3)
K6_BWD_OPS = 14


def _k6_bwd_work(r, nbnd=0):
    """Bytes and flops of one K6 backward. The bytes the gradient needs:
    r, k, v, w and dy in, dr, dk, dv, dw out, the final state's gradient in
    and dstate0 out, u in and du out. With ``nbnd``, also the nbnd states
    the saving forward wrote for the backward to read back: this design's
    checkpoints, which the function itself does not need."""
    B, S, H, hd = r.shape
    state = B * H * hd * hd * 4
    nbytes = (9 * r.numel() * r.element_size() + (2 + nbnd) * state
              + 2 * H * hd * 4)
    return nbytes, K6_BWD_OPS * hd * hd * B * S * H


def _grad_err(got, want):
    return max((g.float() - w.float()).abs().max().item()
               / max(w.float().abs().max().item(), 1e-30)
               for g, w in zip(got, want))


def train_k6(dev, card) -> dict:
    """[train] (a): K6's backward, through rwkv6_scan's autograd Function,
    against autograd through rwkv6_scan_plain on the same leaves, at
    RWKV-6 3B's heads, batch 2, S in (1, 100, 128, 512), fp32 and bf16,
    with the final state's gradient; then timed at S = 512, fp32."""
    res = {"max_abs_err": 0.0}
    for S in (1, 100, 128, 512):
        for dtype in (torch.float32, torch.bfloat16):
            xs = _scan_case(2, S, 40, 64, dev, dtype)
            gen = torch.Generator(device=dev).manual_seed(S)
            dy = torch.randn(xs[0].shape, generator=gen, device=dev)
            ds = torch.randn(xs[5].shape, generator=gen, device=dev)
            grads = []
            for fn in (rwkv6_scan, rwkv6_scan_plain):
                leaves = [x.clone().requires_grad_() for x in xs]
                y, st = fn(*leaves)
                grads.append(torch.autograd.grad(
                    (y * dy).sum() + (st * ds).sum(), leaves))
            torch.cuda.synchronize()
            err = _grad_err(*grads)
            abs_err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(*grads))
            tol = K6_BWD_TOL[dtype]
            print(f"[train] K6 backward B=2 S={S} H=40 hd=64 "
                  f"{str(dtype)[6:]}: max |dgrad| / max |grad| over dr, dk, "
                  f"dv, dw, du, dstate0 {err:.3e} (tolerance {tol:g}), max "
                  f"abs {abs_err:.3e} [{card}]")
            if not (err <= tol):
                raise AssertionError(f"K6 backward S={S} {dtype}: {err}")
            if dtype == torch.float32:
                res["max_abs_err"] = max(res["max_abs_err"], abs_err)
    res.update(time_k6_bwd(dev, card))
    return res


def time_k6_bwd(dev, card) -> dict:
    """K6's training forward (saving its boundary states) and its backward
    timed at B=2, S=512, RWKV-6 3B's heads, fp32, beside autograd through
    the plain recurrence and the bound; also in --timing, so that two
    trees' backward kernels are timed by the same code in one call."""
    from repro_torch.kernels.rwkv6_scan import (SAVE_EVERY, rwkv6_scan_bwd,
                                                rwkv6_scan_save)
    xs = _scan_case(2, 512, 40, 64, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    dy = torch.randn(xs[0].shape, generator=gen, device=dev)
    ds = torch.randn(xs[5].shape, generator=gen, device=dev)
    _, _, bnd = rwkv6_scan_save(*xs)
    fwd_ms = device_ms(lambda: rwkv6_scan_save(*xs))
    bwd = lambda: rwkv6_scan_bwd(*xs[:5], bnd, dy, ds)  # noqa: E731
    ms, dev_ms = cuda_ms(bwd), device_ms(bwd)

    def plain():
        leaves = [x.clone().requires_grad_() for x in xs]
        y, st = rwkv6_scan_plain(*leaves)
        torch.autograd.grad((y * dy).sum() + (st * ds).sum(), leaves)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    bound, by = _bound(*_k6_bwd_work(xs[0]))
    saves, saves_by = _bound(*_k6_bwd_work(xs[0], bnd.shape[0]))
    print(f"[train] K6 at B=2 S=512 H=40 hd=64 fp32: forward saving "
          f"{bnd.shape[0]} states (one per {SAVE_EVERY} steps) device "
          f"{_fmt(fwd_ms)}; backward {ms:.4f} ms (device {_fmt(dev_ms)}), "
          f"autograd through the plain recurrence {plain_ms:.2f} ms, bound "
          f"{bound:.4f} ms ({by}, {K6_BWD_OPS}*hd^2 per step), "
          f"{saves:.4f} ms ({saves_by}) with the saved states read back; no "
          f"single PyTorch call computes it [{card}]")
    # the backward at half and twice the batch: how its time follows its
    # grid (B * H * hd / 16 CTAs on the card's SMs)
    for B in (1, 4):
        xb = _scan_case(B, 512, 40, 64, dev, torch.float32)
        dyb = torch.randn(xb[0].shape, generator=gen, device=dev)
        _, _, bb = rwkv6_scan_save(*xb)
        print(f"[train] K6 backward at B={B} S=512 H=40 hd=64 fp32: device "
              f"{_fmt(device_ms(lambda: rwkv6_scan_bwd(*xb[:5], bb, dyb)))}"
              f" [{card}]")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, with_saves_bound_ms=saves, library_ms=None,
                library_device_ms=None, fwd_save_device_ms=fwd_ms)


def _train_batch(cfg, dev, seed=SEED):
    """TRAIN_B x TRAIN_S inputs: tokens, or seeded embeddings and
    targets for the stubbed frontends."""
    rs = np.random.RandomState(seed)
    if cfg.embed_stub:
        return {"embeds": torch.from_numpy(rs.standard_normal(
                    (TRAIN_B, TRAIN_S, cfg.d_model)).astype(np.float32)).to(
                    dev),
                "targets": torch.from_numpy(rs.randint(
                    0, cfg.vocab_size, (TRAIN_B, TRAIN_S))).to(dev)}
    return {"tokens": torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))).to(dev)}


def _loss_grads(cfg, params, batch):
    """(loss, gradient leaves) of the launcher's loss (fp32 compute)."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import train_step as ts
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        if cfg.embed_stub:
            loss, _ = ts.embed_stub_loss(cfg, params, batch["embeds"],
                                         batch["targets"],
                                         compute_dtype=torch.float32)
        else:
            loss, _ = ts.next_token_loss(cfg, params, batch["tokens"],
                                         compute_dtype=torch.float32)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def _one_step(cfg, params, batch):
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    oc = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    step = make_train_step(cfg, oc, compute_dtype=torch.float32,
                           stub=cfg.embed_stub is not None)
    return step(params, init_opt_state(oc, params), batch)[2]


def _leaf_names(tree, prefix=""):
    """Paths of ``tree_leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


def _leaf_errs(got, want):
    """Each gradient leaf's max |difference| over its largest magnitude."""
    return [(a.cpu() - b.cpu()).abs().max().item()
            / max(b.abs().max().item(), 1e-30) for a, b in zip(got, want)]


@contextlib.contextmanager
def _plain_recurrence():
    """While open, the model's RWKV time mix runs the plain recurrence
    (under autograd: differentiated by autograd) on every device."""
    from repro_torch.models import ssm
    orig = ssm.rwkv6_scan
    ssm.rwkv6_scan = lambda *a, out_state=None: rwkv6_scan_plain(*a)
    try:
        yield
    finally:
        ssm.rwkv6_scan = orig


def train_held(dev, card):
    """[train] (b): one train step of each TRAIN_HELD model at full width,
    2 layers, card against CPU on the same seeded weights and inputs: the
    loss and every gradient leaf (a pass of its own), then the step's loss,
    gnorm and new params (see TRAIN_FIRM). The CPU replays the card's MoE
    top-k choices, as [archs] does. For RWKV-6 the gradients are also taken
    on the card through the plain recurrence, which parts K6's share of the
    difference from the devices' matmuls'."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd
    from repro_torch.models.common import tree_leaves, tree_map
    lr = 1e-3
    for name in TRAIN_HELD:
        cfg = two_layer(name)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        p_dev = init_params(cfg, gen, torch.float32, dev)
        p_cpu = tree_map(lambda t: t.to("cpu", copy=True), p_dev)
        b_dev = _train_batch(cfg, dev)
        b_cpu = {k: v.cpu() for k, v in b_dev.items()}
        n0 = (rwkv6_scan.launches, rwkv6_scan_bwd.launches)
        with _routing() as cc:
            l_dev, g_dev = _loss_grads(cfg, p_dev, b_dev)
        torch.cuda.synchronize()
        k6 = (rwkv6_scan.launches - n0[0], rwkv6_scan_bwd.launches - n0[1])
        with _routing(cc) as wc:
            l_cpu, g_cpu = _loss_grads(cfg, p_cpu, b_cpu)
        errs = _leaf_errs(g_dev, g_cpu)
        names = _leaf_names(p_dev)
        worst = sorted(zip(errs, names), reverse=True)[:3]
        g_err = max(errs)
        l_err = abs(l_dev.item() - l_cpu.item()) / abs(l_cpu.item())
        print(f"[train] {cfg.name}: gradient leaves furthest apart, card vs "
              f"CPU: " + ", ".join(f"{n} {e:.3e}" for e, n in worst)
              + f" [{card}]")
        if k6[0]:
            with _plain_recurrence():
                g_pl = _loss_grads(cfg, p_dev, b_dev)[1]
            print(f"[train] {cfg.name}: gradients on the card through the "
                  f"plain recurrence: K6 against it max |d| / leaf max "
                  f"{max(_leaf_errs(g_dev, g_pl)):.3e}, it against the CPU "
                  f"{max(_leaf_errs(g_pl, g_cpu)):.3e} [{card}]")
            del g_pl
        del g_dev
        with _routing() as cc2:
            m_dev = _one_step(cfg, p_dev, b_dev)
        with _routing(cc2):
            m_cpu = _one_step(cfg, p_cpu, b_cpu)
        s_err = {k: abs(float(m_dev[k]) - float(m_cpu[k]))
                 / abs(float(m_cpu[k])) for k in ("loss", "gnorm")}
        firm_err, loose_err = 0.0, 0.0
        for i, (a, b) in enumerate(zip(tree_leaves(p_dev),
                                       tree_leaves(p_cpu))):
            d = (a.cpu() - b).abs()
            g = g_cpu[i].abs()
            firm = g >= TRAIN_FIRM * g.max()
            if firm.any():
                firm_err = max(firm_err, d[firm].max().item())
            loose_err = max(loose_err, d.max().item())
        # rows are the batch's flattened tokens
        flips = _flips(cc, wc, [(0, TRAIN_B * TRAIN_S)], cfg.num_layers) \
            if cfg.moe is not None else []
        print(f"[train] {cfg.name} (d={cfg.d_model}, 2 layers, batch "
              f"{TRAIN_B} x {TRAIN_S}) card vs CPU: loss rel {l_err:.3e} "
              f"(tolerance {TRAIN_LOSS_TOL:g}), gradients max |d| / leaf max"
              f" {g_err:.3e} (tolerance {TRAIN_GRAD_TOL:g}); the step's "
              f"loss rel {s_err['loss']:.3e}, gnorm rel {s_err['gnorm']:.3e}"
              f" (tolerance {TRAIN_GNORM_TOL:g}); new params max |d| "
              f"{loose_err:.3e} (2 lr = {2 * lr:g}), where |g| >= "
              f"{TRAIN_FIRM:g} of the leaf's max {firm_err:.3e} (5% of lr);"
              f" K6 launches forward {k6[0]}, backward {k6[1]}; MoE top-k "
              f"flips replayed {len(flips)} [{card}]")
        bad = [f for f in flips if f[4] >= FLIP_GAP]
        if not (l_err <= TRAIN_LOSS_TOL and g_err <= TRAIN_GRAD_TOL
                and s_err["loss"] <= TRAIN_LOSS_TOL
                and s_err["gnorm"] <= TRAIN_GNORM_TOL
                and loose_err <= 2 * lr + 1e-5
                and firm_err <= 0.05 * lr) or bad:
            raise AssertionError(f"train {name}: {l_err}, {g_err}, {s_err},"
                                 f" {firm_err}, {loose_err}, flips {bad}")
        if cfg.ssm is not None and cfg.stages[0].pattern[0].kind == "rwkv" \
                and k6 != (2, 2):
            raise AssertionError(f"train {name}: K6 launches {k6}, expected "
                                 f"2 forward and 2 backward")
        del p_dev, p_cpu, g_cpu
        _free()


def train_others(dev, card):
    """[train] (b), the rest: TRAIN_STEPS steps of each TRAIN_OTHERS model
    at full width, 2 layers, on the card: finite loss and gnorm, and the
    params changed."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    for name in TRAIN_OTHERS:
        cfg = two_layer(name)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, gen, torch.float32, dev)
        first = tree_leaves(params)[0].clone()
        oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
        opt = init_opt_state(oc, params)
        step = make_train_step(cfg, oc, compute_dtype=torch.float32,
                               stub=cfg.embed_stub is not None)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        ms = [step(params, opt, _train_batch(cfg, dev, SEED + i))[2]
              for i in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        wall = time.time() - t0
        vals = [(float(m["loss"]), float(m["gnorm"])) for m in ms]
        moved = not torch.equal(first, tree_leaves(params)[0])
        n = sum(p.numel() for p in tree_leaves(params))
        print(f"[train] {cfg.name} (d={cfg.d_model}, {n / 1e9:.2f} B params,"
              f" 2 layers): {TRAIN_STEPS} steps in {wall:.2f} s, (loss, "
              f"gnorm) " + ", ".join(f"({a:.4f}, {b:.3f})" for a, b in vals)
              + f", params changed {moved}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        if not moved or not all(np.isfinite(v).all() for v in vals):
            raise AssertionError(f"train {name}: {vals}, moved {moved}")
        del params, opt, first
        _free()


def _profiled_step(args, cfg, params, card, tag):
    """One more step of the launcher's under torch.profiler: wall, the
    card's busy share and each hand-written kernel's device us per call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd
    from repro_torch.launch import train as train_cli
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.models.common import tree_leaves
    step, oc = train_cli.make_step(args, cfg)
    opt = init_opt_state(oc, params)
    data = SyntheticLM(cfg.vocab_size, batch=args.batch, seq_len=args.seq)
    try:
        batch = train_cli.make_batch(cfg, next(data)["tokens"],
                                     tree_leaves(params)[0].device)
    finally:
        data.close()
    step(params, opt, batch)              # the optimizer state's first step
    torch.cuda.synchronize()
    n0 = (rwkv6_scan.launches, rwkv6_scan_bwd.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.time() - t0
    k6 = (rwkv6_scan.launches - n0[0], rwkv6_scan_bwd.launches - n0[1])
    recs = _device_records(prof)
    busy = sum(us for _, _, us in recs) / 1e6
    per = {}
    for name, _, us in recs:
        owner = kernel_owner(name)
        if owner is not None:
            t, n = per.get(owner, (0.0, 0))
            per[owner] = (t + us, n + 1)
    print(f"[train] {tag}: one step under the profiler: wall {wall:.3f} s, "
          f"device busy {busy:.3f} s ({100 * busy / wall:.1f}%), "
          f"{len(recs)} device records; " + "; ".join(
              f"{o} {t / n:.2f} us per call over {n}"
              for o, (t, n) in sorted(per.items())) + f" [{card}]")
    return k6, per


def train_whole(dev, card, arch, argv):
    """[train] (c) and (d): the whole model through the port's launcher
    (``train`` on full-width weights drawn on the card). Returns (args,
    cfg, params, history, K6 launches (forward, backward) over the run,
    whether every leaf under 16M elements changed)."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd
    from repro_torch.launch import train as train_cli
    from repro_torch.models.common import tree_leaves
    _assert_empty_card("train")
    args = train_cli.build_parser().parse_args(argv)
    cfg = train_cli.make_config(args)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, torch.float32, dev)
    before = [t.clone() for t in tree_leaves(params) if t.numel() < 2**24]
    torch.cuda.reset_peak_memory_stats()
    rwkv6_scan.launches = rwkv6_scan_bwd.launches = 0
    hist = train_cli.train(args, cfg, params,
                           log=lambda s: print(s + f" [{card}]"))
    torch.cuda.synchronize()
    k6 = (rwkv6_scan.launches, rwkv6_scan_bwd.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    secs = sorted(h["seconds"] for h in hist[1:])
    med = secs[len(secs) // 2]
    toks = args.batch * args.seq
    print(f"[train] {cfg.name} whole ({cfg.num_layers} layers, batch "
          f"{args.batch} x {args.seq}, {args.microbatches} microbatch(es), "
          f"fp32): {len(hist)} steps, median step {1e3 * med:.1f} ms (first "
          f"{1e3 * hist[0]['seconds']:.1f} ms), {toks / med:.0f} tokens/s, "
          f"peak {peak:.2f} GiB; ce {hist[0]['ce']:.4f} -> "
          f"{hist[-1]['ce']:.4f}; gnorm {hist[0]['gnorm']:.3f} -> "
          f"{hist[-1]['gnorm']:.3f}; K6 launches forward {k6[0]}, backward "
          f"{k6[1]} [{card}]")
    after = [t for t in tree_leaves(params) if t.numel() < 2**24]
    moved = sum(not torch.equal(a, b) for a, b in zip(before, after))
    print(f"[train] {cfg.name}: {moved} of {len(after)} leaves under 16M "
          f"elements changed [{card}]")
    MEASURED[f"train {cfg.name}"] = (cfg, InputShape(
        "train", args.seq, args.batch, "train"), 1e3 * med)
    if not all(np.isfinite([h["ce"], h["gnorm"]]).all() for h in hist):
        raise AssertionError(f"train {arch}: non-finite {hist}")
    return args, cfg, params, hist, k6, moved == len(after)


def phase_train(dev, card: str) -> tuple:
    """[train]: K6's backward, the four models held card vs CPU, every
    other architecture's steps, then the whole TinyLlama-1.1B and the
    whole RWKV-6 3B through the launcher. Returns (K6 backward's numbers,
    its launches in the whole RWKV-6 run)."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.training.checkpoint import load_checkpoint
    _assert_empty_card("train")
    res = train_k6(dev, card)
    train_held(dev, card)
    train_others(dev, card)
    # (c) the whole TinyLlama-1.1B, its checkpoint written and read back
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    args, cfg, params, hist, _, _ = train_whole(
        dev, card, TINYLLAMA,
        ["--arch", TINYLLAMA, "--steps", "20", "--batch", "8", "--seq",
         "512", "--microbatches", "2", "--ckpt", ckpt])
    t0 = time.time()
    back = load_checkpoint(ckpt, params)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(back)))
    size = sum(os.path.getsize(os.path.join(ckpt, f))
               for f in os.listdir(ckpt)) / 2**30
    print(f"[train] checkpoint {size:.2f} GiB read back in "
          f"{time.time() - t0:.1f} s: equal bit for bit {same} [{card}]")
    shutil.rmtree(ckpt)
    del back
    if not (hist[-1]["ce"] < hist[0]["ce"]) or not same:
        raise AssertionError(f"train {TINYLLAMA}: ce {hist[0]['ce']} -> "
                             f"{hist[-1]['ce']}, checkpoint equal {same}")
    _profiled_step(args, cfg, params, card, TINYLLAMA)
    del params
    _free()
    # (d) the whole RWKV-6 3B
    layers = get_config(RWKV).num_layers
    args, cfg, params, hist, k6, moved = train_whole(
        dev, card, RWKV, ["--arch", RWKV, "--steps", "5", "--batch", "2",
                          "--seq", "512", "--microbatches", "1"])
    k6_step, per = _profiled_step(args, cfg, params, card, RWKV)
    del params
    _free()
    steps = len(hist)
    if k6 != (layers * steps, layers * steps) or \
            k6_step != (layers, layers) or not moved or \
            not {"rwkv6_scan", "rwkv6_scan_bwd"} <= per.keys():
        raise AssertionError(f"train {RWKV}: K6 launches {k6} over {steps} "
                             f"steps, {k6_step} in the profiled step, "
                             f"params changed {moved}, device rows {per}")
    return res, k6[1]


# ---------------------------------------------------------------------------
# phase 11b: the sharded path at world size 1 ([mesh])

MESH_TOL = 1e-6                       # sharded vs unsharded, world size 1
EP_TOL = 1e-5                         # EP vs routed, of the output's scale
ARCH_MESH_TOL = 1e-5                  # [mesh] archs, of the logits' scale
MESH_ARCHS = (RWKV, "hymba-1.5b", "deepseek-v3-671b")


def _mesh_archs(dev, card, mesh):
    """RWKV-6 3B (the time mix over heads, the channel mix over f),
    Hymba-1.5B (Mamba over dI) and DeepSeek-V3's MLA layers at full width,
    2 layers, on the sharded path against the unsharded port on the card:
    prefill 100, partial 40, 8 decode steps."""
    from repro_torch.launch import shard_rules as sr
    from repro_torch.models.sharding import mesh_context
    for name in MESH_ARCHS:
        cfg = two_layer(name)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, gen, torch.float32, dev)
        toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size, 152)
        want, _ = run_model(cfg, params, dev, toks)
        with mesh_context(mesh):
            shards = sr.shard_tree(params, mesh,
                                   specs=sr.model_specs(cfg, mesh))
            del params
            got, cache = run_model(cfg, shards, dev, toks, cache_batch=1)
        torch.cuda.synchronize()
        scale = max(w.abs().max().item() for w in want)
        err = _max_err(got, want) / scale
        finite = all(torch.isfinite(g).all().item() for g in got)
        shapes = {k: tuple(v.shape) for k, v in
                  cache["stages"][0][0].items()}
        print(f"[mesh] {cfg.name} ({cfg.num_layers} layers, d "
              f"{cfg.d_model}) sharded on mesh (1, 1) vs unsharded, prefill "
              f"100 + partial 40 + 8 decode steps: max |dlogits| "
              f"{err:.3e} of the logits' scale {scale:.3f} (tolerance "
              f"{ARCH_MESH_TOL:g}); cache {shapes} [{card}]")
        if not (finite and err <= ARCH_MESH_TOL):
            raise AssertionError(f"mesh {name}: {err}, finite {finite}")
        del shards, cache, got, want
        _free()


def phase_mesh(dev, card: str):
    """[mesh]: a one-rank NCCL group and ``make_local_mesh(1, 1)``; the
    sharded 2-layer TinyLlama-1.1B (full width) prefill, partial prefill
    and decode (K1, K2) and one sharded train step, each against the
    unsharded port on the card; the expert-parallel MoE layer at EP size
    1 against ``routed``. The group is destroyed before the next phase."""
    import torch.distributed as dist

    from repro_torch.launch import shard_rules as sr
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map
    from repro_torch.models.sharding import mesh_context
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    store = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "mesh_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)            # before the DeviceMesh: its device
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_local_mesh(1, 1)
        cfg = two_layer(TINYLLAMA)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, gen, torch.float32, dev)
        toks = np.random.RandomState(SEED).randint(0, cfg.vocab_size, 152)

        def counted(run):
            flash_prefill.launches = decode_attention.launches = 0
            out = run()
            torch.cuda.synchronize()
            return out, (flash_prefill.launches, decode_attention.launches)

        (want, _), n_plain = counted(lambda: run_model(cfg, params, dev,
                                                       toks))
        with mesh_context(mesh):
            shards = sr.shard_tree(params, mesh,
                                   specs=sr.model_specs(cfg, mesh))
            (got, cache), n_mesh = counted(lambda: run_model(
                cfg, shards, dev, toks, cache_batch=1))
        err = _max_err(got, want)
        k = cache["stages"][0][0]["k"]
        print(f"[mesh] {cfg.name} sharded on mesh (1, 1) ('data', 'model') "
              f"over NCCL vs unsharded, prefill 100 + partial 40 + 8 decode "
              f"steps on the reference's cache layout (k {tuple(k.shape)}: "
              f"the sequence over {sr.seq_axes(mesh, 1)!r}, K1 / K2 with "
              f"their LSE, merged): max |dlogits| {err:.3e} (tolerance "
              f"{MESH_TOL:g}); K1, K2 launches {n_mesh} sharded, {n_plain} "
              f"unsharded [{card}]")
        if not err <= MESH_TOL or n_mesh != n_plain or n_mesh != (4, 16):
            raise AssertionError(f"mesh forward: {err}, {n_mesh}, {n_plain}")
        del params, shards, cache
        _free()
        _mesh_archs(dev, card, mesh)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, gen, torch.float32, dev)

        batch = _train_batch(cfg, dev)
        oc = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
        step = make_train_step(cfg, oc, compute_dtype=torch.float32)
        p1 = tree_map(torch.clone, params)
        p1, _, m1 = step(p1, init_opt_state(oc, p1), batch)
        with mesh_context(mesh):
            p2 = sr.shard_tree(params, mesh,
                               specs=sr.model_specs(cfg, mesh))
            p2, _, m2 = step(p2, init_opt_state(oc, p2),
                             {k: sr.shard_batch(v, mesh)
                              for k, v in batch.items()})
        loss_err = abs(m1["loss"].item() - m2["loss"].item()) / \
            abs(m1["loss"].item())
        gn_err = abs(m1["gnorm"].item() - m2["gnorm"].item()) / \
            m1["gnorm"].item()
        leaf_err = max(_leaf_errs(tree_leaves(p2), tree_leaves(p1)))
        print(f"[mesh] one sharded train step (fp32, {TRAIN_B} x "
              f"{TRAIN_S}) vs unsharded: loss {loss_err:.3e}, gnorm "
              f"{gn_err:.3e}, updated leaves {leaf_err:.3e} of their scale "
              f"(tolerance {MESH_TOL:g}) [{card}]")
        if not max(loss_err, gn_err, leaf_err) <= MESH_TOL:
            raise AssertionError(f"mesh train step: {loss_err}, {gn_err}, "
                                 f"{leaf_err}")
        del params, p1, p2
        _free()

        qcfg = get_config(QWEN)
        E = qcfg.moe.num_experts
        # capacity E / k * ... holds every assignment: nothing dropped
        qcfg = dataclasses.replace(qcfg, moe=dataclasses.replace(
            qcfg.moe, capacity_factor=float(E)))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        p = {k: v[0] for k, v in moe.init_moe_params(
            gen, qcfg, torch.float32, dev, 1).items() if k != "shared"}
        x = torch.randn((64, qcfg.d_model), generator=gen, device=dev)
        want, aux_w = moe.routed(qcfg, p, x)
        with mesh_context(mesh):
            specs = {k: sr.param_spec(("moe", k), v.shape, mesh)
                     for k, v in p.items()}
            got, aux_g = moe.routed_ep(qcfg, p, x, mesh, specs)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item() / want.abs().max().item()
        ea = abs(aux_g.item() - aux_w.item())
        print(f"[mesh] {QWEN} MoE layer ({E} experts, top-{qcfg.moe.top_k}, "
              f"64 tokens) expert-parallel at EP size 1 vs routed: "
              f"{e:.3e} of the output's scale (tolerance {EP_TOL:g}), aux "
              f"{ea:.3e} [{card}]")
        if not (e <= EP_TOL and ea <= MESH_TOL):
            raise AssertionError(f"mesh EP: {e}, aux {ea}")
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


# ---------------------------------------------------------------------------
# phase 11c: the cost model against the card ([cost])

MEASURED = {}          # [train] and [gemma]: "name" -> (cfg, shape, ms)


def phase_cost(card: str):
    """[cost]: the port's roofline prediction (``launch/roofline_model.py``
    over ``launch/mesh.py``'s H100 peaks, fp32 compute, fp32 weight bytes)
    beside the time [train] and [gemma] measured for the same step, and
    one dry-run subprocess's record. Runs nothing on the card again."""
    from repro_torch.launch.roofline_model import (analytic_bytes,
                                                   analytic_flops,
                                                   roofline_terms)
    kinds = sorted(name.split()[0] for name in MEASURED)
    if kinds != ["gemma", "gemma", "train", "train"]:
        raise AssertionError(f"[cost] needs the two whole-model train "
                             f"steps and Gemma-2's decode steps: {MEASURED}")
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[cost] device total_memory {total} B ({total / 1e9:.2f} GB) "
          f"beside the roofline's HBM_BYTES {HBM_BYTES} B [{card}]")
    for name, (cfg, ish, ms) in MEASURED.items():
        flops = analytic_flops(cfg, ish)
        nbytes = analytic_bytes(cfg, ish, 1, dtype_bytes=4)
        t = roofline_terms(flops, nbytes, 0.0, FP32_FLOPS)
        t.pop("collective_s")
        dom = max(t, key=t.get)
        print(f"[cost] {name} ({cfg.num_layers} layers, batch "
              f"{ish.global_batch} x {ish.seq_len}): predicted compute "
              f"{1e3 * t['compute_s']:.2f} ms ({flops:.4g} FLOP at "
              f"{FP32_FLOPS:g}/s), memory {1e3 * t['memory_s']:.2f} ms "
              f"({nbytes:.4g} B at {HBM_BYTES_PER_S:g} B/s), dominant "
              f"{dom}; measured {ms:.2f} ms = "
              f"{ms / (1e3 * t[dom]):.2f}x the prediction [{card}]")
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "dryrun")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         TINYLLAMA, "--shape", "decode_32k", "--out", out],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    files = os.listdir(out) if os.path.isdir(out) else []
    if proc.returncode != 0 or len(files) != 1:
        raise AssertionError(f"dry run rc {proc.returncode}, {files}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    with open(os.path.join(out, files[0])) as f:
        rec = json.load(f)
    shutil.rmtree(out)
    print(f"[cost] python -m repro_torch.launch.dryrun --arch {TINYLLAMA} "
          f"--shape decode_32k: rc 0 in {time.time() - t0:.1f} s (a fake "
          f"process group, meta tensors: nothing runs on the card); "
          f"record: " + json.dumps({k: rec[k] for k in (
              "status", "devices", "per_device", "memory_analysis",
              "model_flops_per_device", "useful_flops_ratio",
              "roofline_terms_s", "dominant_term")}) + f" [{card}]")
    if rec["status"] != "ok" or rec["devices"] != 256:
        raise AssertionError(f"dry run record {rec}")


# ---------------------------------------------------------------------------
# phase 12: every app under every scheme ([apps])

TINYLLAMA = "tinyllama-1.1b"
ALL_SCHEMES = list(serve_cli.SCHEMES)
BASELINES = ["LlamaDist-PO", "LlamaDist-TO", "AutoGen-TO", "LlamaDistPC-TO"]
DENSE = (flash_prefill, decode_attention)
PAGED_NO_SPEC = (paged_decode_attention, chunk_prefill_attention)


def _card_engines(dev, **opts):
    """``build_engines`` on the card with TinyLlama-1.1B (22 layers, random
    fp32 weights from SEED) as the core LLM; the lite LLM stays the
    repo's tiny-lite-llm. The encoders hold the weights their seed draws
    on the CPU generator, moved to the card: the CPU tests' encoders, so
    that the retrieval checks hold the card to the path those tests
    check (random encoders rank chunks by chance, and another draw can
    miss the question's topic)."""
    engines = build_engines(device=dev, **opts)
    engines["core_llm"] = LLMEngine(
        "core_llm", get_config(TINYLLAMA), seed=SEED, max_batch=4,
        device=dev, paged=opts.get("paged_kv", False),
        chunked_prefill=opts.get("chunked_prefill", False),
        prefill_chunk=opts.get("prefill_chunk", 128),
        prefix_cache=opts.get("prefix_cache", "none"))
    for name, cls in (("embedding", EmbeddingEngine),
                      ("rerank", RerankEngine)):
        engines[name].params = tree_to(cls(device="cpu").params, dev)
    return engines


def _texts(v) -> list:
    return [c.get("text", "") if isinstance(c, dict) else c
            for c in (v if isinstance(v, list) else [])]


def _topic_hit(app: str, ctx, question: str) -> None:
    """naive-RAG and advanced-RAG: the chunks handed to synthesis name
    the question's topic (tests/test_runtime_e2e.py's check)."""
    if app not in ("naive_rag", "advanced_rag"):
        return
    key = "retrieved" if app == "naive_rag" else "top_chunks"
    topic = question.split()[-1]
    if topic not in " ".join(_texts(ctx.store.get(key))):
        raise AssertionError(f"{app} {ctx.qid}: {key} misses {topic!r}")


def _summary(ctx) -> tuple:
    return (ctx.store.get("answer"),
            tuple(_texts(ctx.store.get("top_chunks")
                         or ctx.store.get("retrieved")
                         or ctx.store.get("web_results"))))


def _ctx_signature(ctx) -> str:
    chunks = ctx.store.get("ctx_chunks")
    top = _texts(ctx.store.get("top_chunks"))
    n_none = sum(c is None for c in chunks) if isinstance(chunks, list) \
        else "no list"
    return (f"ctx_chunks {n_none} of {len(chunks or [])} None, "
            f"{sum(1 for t in top if t)} of {len(top)} retrieved texts "
            f"non-empty")


def phase_apps(dev, card: str):
    """Every app under every scheme of serve.SCHEMES on the card. Under
    Teola, advanced-RAG, search-gen and contextual retrieval each get
    phase 5's measurement (a warm-up query, 4 questions together, a
    profiled query); naive-RAG under Teola is phase 5 itself. Each
    baseline gets a warm-up and one query per app, LlamaDistPC last (it
    turns the engines' prefix cache on for good)."""
    torch.cuda.reset_peak_memory_stats()
    engines = _card_engines(dev)
    docs = doc_corpus(2)
    teola_first, peak = {}, 0
    for app in ("advanced_rag", "search_gen", "contextual_retrieval"):
        peak = max(peak, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        print(f"[apps] {app} under Teola: core_llm {TINYLLAMA}, "
              f"{_layers(engines)} layers, dense KV; decode tokens counted "
              f"over core_llm and lite_llm")
        teola = Teola(ALL_APPS[app](engines), engines)
        try:
            for fn in DENSE:
                fn.launches = 0
            warm, _ = _warm_up(teola, docs)
            dec0 = _decoded(engines)
            wall, ctxs, busy = _run_window(teola, docs)
            launches = {fn.__name__: fn.launches for fn in DENSE}
            dec = _decoded(engines) - dec0
            _profiled_query(teola, docs, card, DENSE)
        finally:
            teola.shutdown()
        _check_answers(ctxs)
        for c, q in zip(ctxs, QUESTIONS):
            _topic_hit(app, c, q)
        _print_window(f"apps {app}", warm, wall, ctxs, dec, busy, launches,
                      card)
        teola_first[app] = ctxs[0]
    for name in BASELINES:
        cls, policy = serve_cli.SCHEMES[name]
        for app in ALL_APPS:
            for fn in DENSE:
                fn.launches = 0
            orch = cls(ALL_APPS[app](engines), engines, policy=policy)
            try:
                t0 = time.time()
                _, wctx = orch.query({"question": "what is fact 1 about "
                                      "optics", "docs": docs}, timeout=600)
                warm = time.time() - t0
                t0 = time.time()
                _, ctx = orch.query({"question": QUESTIONS[0],
                                     "docs": docs}, timeout=600)
                lat = time.time() - t0
            finally:
                orch.shutdown()
            _check_answers([wctx, ctx])
            _topic_hit(app, ctx, QUESTIONS[0])
            launches = {fn.__name__: fn.launches for fn in DENSE}
            same = "" if app not in teola_first else (
                f"; retrieved set and answer equal Teola's: "
                f"{_summary(ctx) == _summary(teola_first[app])} (printed "
                f"only: batch shapes differ between schemes)")
            sig = f"; {_ctx_signature(ctx)}" \
                if app == "contextual_retrieval" else ""
            print(f"[apps] {app} under {name}: warm-up {warm:.3f} s, query "
                  f"{lat:.3f} s, answer {len(ctx.store['answer'].split())} "
                  f"words, launches over the 2 queries " + ", ".join(
                      f"{k} {n}" for k, n in launches.items())
                  + f"{same}{sig} [{card}]")
            for k, n in launches.items():
                if n <= 0:
                    raise AssertionError(f"{k} was not launched under "
                                         f"{name} ({app})")
    print(f"[apps] contextual_retrieval under Teola (ROADMAP Queue 3): "
          f"{_ctx_signature(teola_first['contextual_retrieval'])}; the "
          f"baselines' lines above hold the contextualized chunks")
    peak = max(peak, torch.cuda.max_memory_allocated())
    print(f"[apps] {len(ALL_SCHEMES)} schemes x {len(ALL_APPS)} apps on the "
          f"card; peak max_memory_allocated over the phase "
          f"{peak / 2**30:.2f} GiB [{card}]")


def _decoded(engines) -> int:
    return sum(inst.stats["decode_tokens"] for e in engines.values()
               for inst in replicas_of(e) if "decode_tokens" in
               getattr(inst, "stats", {}))


# ---------------------------------------------------------------------------
# phase 13: the serving layers through the serve entry point ([layers])

def _audit_pools(tag: str, engines) -> list:
    """Every paged replica after release: a clean audit, 0 leaked blocks,
    0 bad frees, and every block free but the radix tree's."""
    rows = []
    for e in engines.values():
        for inst in replicas_of(e):
            alloc = getattr(inst, "alloc", None)
            if alloc is None:
                continue
            audit = alloc.audit()
            held = inst.radix.num_blocks() if inst.radix is not None else 0
            if not audit["ok"] or audit["leaked"] or audit["bad_free"] or \
                    alloc.free_blocks() != alloc.capacity - held or \
                    inst.states:
                raise AssertionError(
                    f"[{tag}] {inst.name}: pool not clean after release: "
                    f"audit {audit}, {alloc.free_blocks()} free of "
                    f"{alloc.capacity}, {held} radix-held, "
                    f"{len(inst.states)} sequences resident")
            rows.append(f"{inst.name} {alloc.free_blocks()}/"
                        f"{alloc.capacity}")
    print(f"[{tag}] pools after release, free of capacity (audit clean, 0 "
          f"leaked, 0 bad frees): " + (", ".join(rows) or "no paged pool"))
    return rows


def _serve_case(tag, dev, card, argv, kernels):
    """One [layers] case through the port's serve functions: the flags
    parsed and validated by serve.py, the engines of ``_card_engines``
    turned into the flags' engine dict by ``make_engines``, served by
    ``serve``. Returns (orchestrator, contexts, engines)."""
    ap = serve_cli.build_parser()
    args = ap.parse_args(argv + ["--app", "naive_rag"])
    serve_cli.validate_args(ap, args)
    opts = dict(paged_kv=args.paged_kv, chunked_prefill=args.chunked_prefill,
                prefill_chunk=args.prefill_chunk,
                prefix_cache=args.prefix_cache)
    engines = serve_cli.make_engines(
        args, base=_card_engines(dev, **opts))
    print(f"[{tag}] serve.py {' '.join(argv)} (core_llm {TINYLLAMA}, "
          f"{_layers(engines)} layers)")
    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    orch, ctxs = serve_cli.serve(args, engines)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"[{tag}] warm-up and {len(ctxs)} queries in {wall:.3f} s; "
          f"launches " + ", ".join(f"{k} {n}" for k, n in launches.items())
          + f"; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"[{tag}] {name} was not launched")
    return orch, ctxs, engines


def _all_done(tag, ctxs, allowed=()):
    for c in ctxs:
        if c.error is not None and not isinstance(c.error, allowed):
            raise AssertionError(f"[{tag}] {c.qid} failed: {c.error!r}")
        if c.error is None and not c.store.get("answer"):
            raise AssertionError(f"[{tag}] {c.qid}: empty answer")


def _engine_preemption(tag, core, card):
    """tests/test_slo_sched.py's real-engine construction on the card: a
    sequence decodes 4 steps, is preempted (its blocks freed), re-admitted
    and replayed through the prefill kernel (K5), and finishes 6 steps
    later with the tokens of an unpreempted run."""
    from repro_torch.engines.decode_loop import DecodeSeq

    def fresh(sid):
        core.op_prefill([{"sid": sid, "text": "some moderately long "
                          "prompt words here about optics"}])
        seq = DecodeSeq(sid, core.states[sid], 10,
                        text_fn=lambda q: core.tok.decode(q.tokens))
        if not core.try_admit(seq):
            raise AssertionError(f"[{tag}] {sid} not admitted")
        core.note_slot_acquired(seq)
        return seq

    def drive(seq, iters):
        for _ in range(iters):
            before = len(seq.tokens)
            core.decode_iteration([seq])
            seq.steps += max(1, len(seq.tokens) - before)

    base = fresh("base")
    drive(base, 10)
    core.note_slot_released(base)
    core.release("base")
    seq = fresh("pre")
    drive(seq, 4)
    free0 = core.alloc.free_blocks()
    core.preempt_decode(seq)
    freed = core.alloc.free_blocks() - free0
    if not core.try_admit(seq):
        raise AssertionError(f"[{tag}] preempted sequence not re-admitted")
    core.note_slot_acquired(seq)
    n5 = chunk_prefill_attention.launches
    drive(seq, 6)
    torch.cuda.synchronize()
    replay = chunk_prefill_attention.launches - n5
    core.note_slot_released(seq)
    core.release("pre")
    ok = seq.tokens == base.tokens
    print(f"[{tag}] engine-level preemption (tests/test_slo_sched.py's "
          f"construction): {freed} blocks freed, replay {replay} K5 "
          f"launches, continuation token-identical: {ok} [{card}]")
    if freed <= 0 or replay <= 0 or not ok:
        raise AssertionError(f"[{tag}] preemption replay: freed {freed}, "
                             f"K5 launches {replay}, identical {ok}")


def phase_layers(dev, card: str):
    """The serving layers through serve.py's functions on the card: (a)
    two replicas with streaming, (b) SLO scheduling with preemption, (c)
    a crash of core-LLM replica 1 and its recovery, (d) disaggregated
    prefill/decode with KV migration, (e) overload control shedding a
    burst. After each, every paged pool audits clean."""
    # (a) both replicas serve
    orch, ctxs, engines = _serve_case(
        "layers a", dev, card, ["--llm-instances", "2", "--streaming",
                                "--continuous-batching", "--queries", "4",
                                "--rate", "50"], DENSE)
    _all_done("layers a", ctxs)
    per = {inst.name: inst.stats["decode_tokens"]
           for inst in replicas_of(engines["core_llm"])}
    print(f"[layers a] decode tokens per core_llm replica: {per}")
    if len(per) != 2 or min(per.values()) <= 0:
        raise AssertionError(f"[layers a] a replica did not serve: {per}")
    del orch, engines
    _free()

    # (b) SLO scheduling: two tenants alternating classes, arrivals
    # spread at 4 per second; the hard preemption check is the
    # reference's real-engine construction, after the window
    orch, ctxs, engines = _serve_case(
        "layers b", dev, card, ["--continuous-batching", "--paged-kv",
                                "--slo-sched", "--queries", "4",
                                "--rate", "4"], PAGED_NO_SPEC)
    _all_done("layers b", ctxs)
    core = engines["core_llm"]
    stats = core.tenant_stats()
    served = sum(r.get("preempted", 0) for r in stats.values())
    print(f"[layers b] preemptions in the served window: {served} "
          f"(printed: they follow the arrival timing)")
    _audit_pools("layers b", engines)
    _engine_preemption("layers b", core, card)
    _audit_pools("layers b", engines)
    del orch, engines, core
    _free()

    # (c) a crash of core-LLM replica 1 at its 3rd decode call
    orch, ctxs, engines = _serve_case(
        "layers c", dev, card, ["--llm-instances", "2",
                                "--continuous-batching", "--paged-kv",
                                "--fault-inject",
                                "crash:core_llm.r1:decode:3",
                                "--queries", "4", "--rate", "50"],
        PAGED_NO_SPEC)
    _all_done("layers c", ctxs)
    mgr = orch.runtime.scheds["core_llm"].ftmgr
    kinds = [e[0] for e in mgr.events]
    pool = engines["core_llm"]
    dead = [i for i in range(len(pool)) if pool.health(i) == "dead"]
    print(f"[layers c] recovery events: {kinds}; dead replicas "
          f"{[pool[i].name for i in dead]}; reclaim "
          f"{mgr.reclaim_reports}")
    if dead != [1] or "retry" not in kinds or not mgr.reclaim_reports or \
            not all(r["ok"] and r["leaked"] == 0
                    for r in mgr.reclaim_reports):
        raise AssertionError(f"[layers c] no clean recovery: {mgr.events}")
    _audit_pools("layers c", engines)
    del orch, engines, pool, mgr
    _free()

    # (d) disaggregated prefill/decode, 1 + 1
    orch, ctxs, engines = _serve_case(
        "layers d", dev, card, ["--paged-kv", "--continuous-batching",
                                "--disaggregate", "--queries", "4",
                                "--rate", "50"], PAGED_NO_SPEC)
    _all_done("layers d", ctxs)
    mig = {inst.name: (inst.stats["migrations_in"],
                       inst.stats["migrated_blocks"],
                       round(inst.stats["migrate_s"], 4))
           for inst in replicas_of(engines["core_llm"])}
    print(f"[layers d] core_llm migrations in / blocks / seconds per "
          f"replica: {mig} [{card}]")
    if sum(m[0] for m in mig.values()) <= 0:
        raise AssertionError("[layers d] no sequence migrated")
    _audit_pools("layers d", engines)
    del orch, engines
    _free()

    # (e) overload control sheds a burst
    from repro_torch.serving.overload import Overloaded
    orch, ctxs, engines = _serve_case(
        "layers e", dev, card, ["--continuous-batching", "--overload-control",
                                "--query-deadline", "60",
                                "--shed-queue-tokens", "64", "--queries",
                                "4", "--rate", "100"], DENSE)
    _all_done("layers e", ctxs, allowed=(Overloaded,))
    shed = [c for c in ctxs if isinstance(c.error, Overloaded)]
    print(f"[layers e] shed {len(shed)} of {len(ctxs)} with a structured "
          f"Overloaded ({[c.error.reason for c in shed]}), "
          f"{len(ctxs) - len(shed)} completed")
    if not shed or len(shed) == len(ctxs):
        raise AssertionError(f"[layers e] shed {len(shed)} of {len(ctxs)}")
    del orch, engines
    _free()


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def phase_examples(card: str):
    """The port's examples (repro_torch/examples/), each once on the card
    in this process: quickstart and serve_batched must print what
    tests/test_examples.py holds the reference's to, colocated_apps must
    answer every query of both apps. Their engines are the repo's tiny
    ones."""
    import io
    from repro_torch.examples import colocated_apps, quickstart
    from repro_torch.examples import serve_batched
    runs = (("quickstart", lambda: quickstart.main(device="cuda"),
             ("optimized e-graph", "end-to-end latency")),
            ("serve_batched", lambda: serve_batched.main(3, device="cuda"),
             ("served 3 queries", "topology-aware batching")),
            ("colocated_apps", lambda: colocated_apps.main(device="cuda"),
             ("avg latency",)))
    for name, run, want in runs:
        n0 = {fn.__name__: fn.launches for fn in DENSE}
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            ret = run()
        torch.cuda.synchronize()
        text = buf.getvalue()
        n = {fn.__name__: fn.launches - n0[fn.__name__] for fn in DENSE}
        lines = [ln for ln in text.splitlines() if any(w in ln for w in want)]
        print(f"[examples] python -m repro_torch.examples.{name}: "
              f"{time.time() - t0:.1f} s, launches " + ", ".join(
                  f"{k} {v}" for k, v in n.items()) + f" [{card}]")
        for ln in lines:
            print(f"[examples]   {ln.strip()}")
        missing = [w for w in want if w not in text]
        if missing:
            raise AssertionError(f"examples {name}: {missing} not printed")
        if name == "colocated_apps":
            bad = {app: texts for app, texts in ret.items()
                   if len(texts) != 3 or not all(
                       isinstance(t, str) and t for t in texts)}
            if sorted(ret) != ["rag", "search_gen"] or bad:
                raise AssertionError(f"colocated_apps answers: {ret}")


def phase_exit(card: str):
    """The serve entry point in a process of its own on the card (its
    tiny engines): one query, shutdown, and a clean interpreter exit."""
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--app",
         "naive_rag", "--queries", "1"], capture_output=True, text=True,
        timeout=300, env=env)
    print(f"[exit] python -m repro_torch.launch.serve --app naive_rag "
          f"--queries 1: rc {proc.returncode} in {time.time() - t0:.1f} s; "
          + "; ".join(proc.stdout.strip().splitlines()) + f" [{card}]")
    if proc.returncode != 0 or "terminate called" in proc.stderr or \
            "[serve] 1/1 queries" not in proc.stdout:
        raise AssertionError(f"serve process failed: rc {proc.returncode}"
                             f"\n{proc.stderr[-2000:]}")


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
    if MOE_TIMING:
        time_moe_experts(dev, card)
        return 0
    if TIMING:
        print(f"[timing] repro_torch from {SRC} [{card}]")
        build.build_all()
        phase_kernels(dev)
        phase_paged_kernels(dev)
        phase_rwkv_kernel(dev)
        time_k6_bwd(dev, card)
        phase_serve(dev, card, RWKV, (rwkv6_scan,), "rwkv-serve")
        # the whole TinyLlama-1.1B step through the tree's own launcher,
        # then one more step profiled (the card's busy share)
        args, cfg, params, _, _, _ = train_whole(
            dev, card, TINYLLAMA, ["--arch", TINYLLAMA, "--steps", "6",
                                   "--batch", "8", "--seq", "512",
                                   "--microbatches", "2"])
        _profiled_step(args, cfg, params, card, TINYLLAMA)
        return 0
    start = time.time()

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        _free()
        print(f"[time] {name}: {time.time() - t0:.1f} s (script "
              f"{time.time() - start:.1f} s)")
        return out

    timed("toolchain", phase_toolchain, card)
    timed("build", phase_build)
    kres = timed("kernels", phase_kernels, dev)
    kres.update(timed("paged kernels", phase_paged_kernels, dev))
    timed("model", phase_model, dev)
    launches, answers = timed("serve", phase_serve, dev, card)
    launches.update(timed("paged", phase_serve_paged, dev, card, answers))
    kres["rwkv6_scan"] = timed("rwkv kernel", phase_rwkv_kernel, dev)
    timed("rwkv model", phase_rwkv_model, dev)
    launches.update(timed("rwkv-serve", phase_serve, dev, card, RWKV,
                          (rwkv6_scan,), "rwkv-serve")[0])
    timed("archs", phase_archs, dev, card)
    timed("moe", phase_moe, dev, card)
    timed("hybrid", phase_hybrid, dev, card)
    timed("gemma", phase_gemma, dev, card)
    kres["rwkv6_scan_bwd"], k6_bwd = timed("train", phase_train, dev, card)
    launches["rwkv6_scan_bwd"] = k6_bwd
    timed("mesh", phase_mesh, dev, card)
    timed("cost", phase_cost, card)
    timed("apps", phase_apps, dev, card)
    timed("layers", phase_layers, dev, card)
    timed("examples", phase_examples, card)
    timed("exit", phase_exit, card)
    paged_src = "src/repro_torch/csrc/paged_attention.cu"
    sources = {"flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                                 "src/repro/kernels/flash_prefill.py:75"),
               "decode_attention": (
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:107"),
               "verify_attention": (
                   paged_src, "src/repro/kernels/decode_attention.py:232"),
               "paged_decode_attention": (
                   paged_src, "src/repro/kernels/decode_attention.py:281"),
               "chunk_prefill_attention": (
                   "src/repro_torch/csrc/chunk_prefill.cu",
                   "src/repro/kernels/chunk_prefill.py:102"),
               "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                              "src/repro/kernels/rwkv6_scan.py:52"),
               # K6's gradient: no Pallas counterpart (the reference
               # differentiates a lax.scan); the kernel it differentiates
               "rwkv6_scan_bwd": ("src/repro_torch/csrc/rwkv6_scan_bwd.cu",
                                  "src/repro/kernels/rwkv6_scan.py:52")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = kres[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "device_ms": r["device_ms"],
                        "library_device_ms": r["library_device_ms"]})
        for extra in ("hd256", "tc_bound_ms", "needed_bound_ms",
                      "cold_device_ms", "fwd_save_device_ms",
                      "with_saves_bound_ms", "lse_max_abs_err",
                      "lse_device_ms"):
            if extra in r:
                kernels[-1][extra] = r[extra]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
