"""One run of one cell: set-up, the window, the drain of an open loop, the
correctness comparison, and the numbers every reader takes from."""
from __future__ import annotations

import gc
import sys
import time

import torch

from harness import cells, check, system, trace, weights, window, work
from harness.traffic import Traffic

# the profiled slice of a traced window: from 40% of it, a quarter of it,
# at most 8 s (a Qwen1.5-MoE decode step is ~5,000 device records)
SLICE_AT, SLICE_SHARE, SLICE_MAX_S = 0.4, 0.25, 8.0


def log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _peak() -> int:
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0


def _warm_profiler(device):
    """One short profile in set-up, so that the slice's profiler starts
    warm (CUPTI's first start is slow)."""
    prof = trace.profiler()
    prof.start()
    torch.ones(1, device=device).add_(1)
    _sync()
    prof.stop()


def _slice_data(sl, kernels) -> dict:
    """The profiled slice's device records reduced to what the readers
    take: busy seconds, top operations, idle gaps, device seconds per
    kernel wrapper, the kernels' bounds, the engine's token counts."""
    recs = trace.device_records(sl.prof)
    events = [e for e in sl.prof.profiler.kineto_results.events()
              if e.name() == "bench.slice"]
    if events:
        t0 = events[0].start_ns() / 1e9
        t1 = t0 + events[0].duration_ns() / 1e9
    elif recs:
        t0, t1 = recs[0][1], max(e for _, _, e in recs)
    else:
        t0, t1 = 0.0, sl.length
    owner_s = {}
    for name, s, e in recs:
        own = trace.kernel_owner(name)
        if own is not None and e > t0 and s < t1:
            owner_s[own] = owner_s.get(own, 0.0) + min(e, t1) - max(s, t0)
    return {"seconds": t1 - t0, "summary": trace.summarize(recs, t0, t1),
            "owner_device_s": owner_s, "bounds": kernels.bounds(),
            "stats": sl.stats, "records": len(recs)}


def warm_up(teola, core, traffic, max_batch):
    """The cell's warm-up: a query on the first two documents of the
    seed's pool, then a batch of ``max_batch`` prefills of the first."""
    docs = traffic.docs
    t_q, t_b = system.warm_up(teola, core,
                              {"question": f"what is fact 0 about "
                                           f"{docs[0]['topic']}",
                               "docs": docs[:2]},
                              max_batch, docs[0]["text"])
    log(f"warm-up: one query {t_q:.2f} s, a batch of {max_batch} "
        f"{t_b:.2f} s")


def run(root, bench_dir, name: str, seed: int, seconds: float, trace_on:
        bool, t_process: float, device="cuda", precision="float32") -> dict:
    """Runs the cell; returns {"run": what the readers read, "numbers":
    the compared numbers, "limits", "correct", "attempted", "failed",
    "memory_peak_bytes", "per_layer", "end_to_end", "readers"}."""
    c = cells.load(root, bench_dir, name)
    conf, mix = c["conf"], c["mix"]
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    traffic = Traffic(mix, seed)
    sv = conf["serving"]
    t_build = time.time()
    teola, engines, params, enc = system.build(conf, mix, seed, device,
                                               dtype)
    log(f"set-up: process start to build {t_build - t_process:.2f} s, "
        f"weights and engines {time.time() - t_build:.2f} s")
    core = engines["core_llm"]
    cap = system.Capture(engines)
    kernels = sl = None
    try:
        warm_up(teola, core, traffic, sv["max_batch"])
        offsets = traffic.open_schedule(seconds)
        queries = traffic.queries(len(offsets))
        if trace_on:
            _warm_profiler(device)
            kernels = system.KernelCalls()
            sl = window.Slice(SLICE_AT * seconds,
                              min(SLICE_MAX_S, SLICE_SHARE * seconds),
                              core, kernels)
        _sync()
        peak_setup = _peak()
        mark = {}

        def opens():
            """At the window's start: the engine's counters, the peak."""
            mark["s0"] = dict(core.stats)
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
        hooks = [(0.0, opens)] + (sl.hooks() if sl is not None else [])
        cap.on = True
        setup_s = time.time() - t_process
        t0, t_close, t_end, recs = window.open_loop(
            teola, queries, offsets, seconds, float(mix["drain_s"]), hooks)
        rows = window.summarize(recs)
        cap.on = False
        s1 = dict(core.stats)
        _sync()
        peak_window = _peak()
        slice_data = None
        if sl is not None:
            slice_data = _slice_data(sl, kernels)
    finally:
        if kernels is not None:
            kernels.close()
        teola.shutdown()
        # a query still unanswered when the drain ends would leave its
        # sequences' KV resident in the engines
        for eng in engines.values():
            for inst in system.replicas(eng):
                for sid in list(getattr(inst, "states", {})):
                    inst.release(sid)
    run_rec = {
        "seconds": seconds, "setup_s": setup_s,
        "window": (t0, t_close), "drain_end": t_end, "queries": rows,
        "stats": {k: s1[k] - mark["s0"][k] for k in
                  ("prefill_tokens", "decode_tokens", "decode_iters")},
        "decode_spans": list(cap.spans), "window_peak_bytes": peak_window,
        "flops": work.token_flops(conf), "slice": slice_data}
    memory_peak = max(peak_setup, peak_window)
    # the program's state goes before the reference runs on the card: only
    # the weights the benchmark drew stay (the queries' contexts hold the
    # engines through their errors' tracebacks)
    del teola, engines, core, sl, kernels, recs, hooks, mark
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        log(f"after the window: {torch.cuda.memory_allocated() / 2**30:.2f}"
            f" GiB allocated for the reference's weights and work")
    bad = [r for r in rows if not r["ok"]]
    finished = [r["qid"] for r in rows if r["ok"]]
    numbers = {}
    sample = check.sample_generations(cap.gens, finished, seed)
    if dtype != torch.float32:
        del params
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        params = weights.decoder_params(conf, seed, device)
    t_ref = time.time()
    if sample:
        numbers["token_gap_mean"], widest, n_tok = check.token_gap(
            conf, params, sample)
        log(f"token gap read at {n_tok} served tokens of {len(sample)} "
            f"generations: widest {widest!r}")
    numbers.update(check.retrieval_checks(
        conf, enc, cap.rec, seed, control=None if dtype == torch.float32
        else dtype))
    log(f"reference: {time.time() - t_ref:.1f} s")
    numbers["failed_queries"] = float(len(bad))
    limits = dict(conf["limits"], failed_queries=0.0)
    correct, rows_cmp = check.verdict(numbers, limits)
    correct = correct and bool(sample)
    return {"run": run_rec, "numbers": rows_cmp, "correct": correct,
            "attempted": len(rows), "failed": len(bad),
            "memory_peak_bytes": memory_peak, "cell": c}
