"""Serving launcher of the PyTorch/CUDA port (the counterpart of
``repro/launch/serve.py``, with the same flags and printed lines): stand
up an app (all four of the paper's workflows) on the engine pool and
serve queries.

  PYTHONPATH=src python -m repro_torch.launch.serve --app advanced_rag \
      --queries 4 [--sim] [--scheme Teola|LlamaDist-TO|...] \
      [--llm-instances 2] [--streaming] [--device cuda|cpu]

--device places the real engines' weights and caches (default cuda: the
hand-written kernels; cpu runs their plain PyTorch versions).

--llm-instances N puts each LLM engine behind an EnginePool of N replicas
(shared weights, per-replica KV stores; fused batches are routed to the
least-loaded replica). --streaming enables decode->downstream chunk
pipelining; --continuous-batching dispatches decodes into each replica's
persistent decode loop (iteration-level continuous batching) instead of
run-to-completion batches (both Teola scheme only). --paged-kv carves
each replica's KV cache into refcounted token blocks (copy-on-write
instruction-prefix sharing, block-table indexed decode, occupancy and
router backpressure counted in allocated blocks). --speculative enables
draft-verify speculative decoding on core_llm (--draft-k tokens drafted
per target verification step; --spec-drafter picks the model-free
prompt-lookup drafter or the co-located lite_llm replica pairing);
greedy outputs stay token-identical to plain decode. --chunked-prefill
streams prompts through each replica's continuous loop as bounded
chunks mixed with decode iterations (--prefill-chunk tokens per chunk
under a per-iteration --token-budget), so a long prompt never
head-of-line-blocks co-resident decodes; chunked prefill is
token-identical to monolithic prefill by construction.
--prefix-cache radix enables the global radix-tree prefix cache on each
LLM replica (requires --paged-kv): ANY prompt sharing a cached
block-aligned token prefix — across queries and tenants, not just
warmed instructions — forks the cached blocks and prefills only the
uncached tail, with LRU leaf eviction under memory pressure and
prefix-aware pool routing; outputs stay token-identical to the cache
being off. --disaggregate (requires --paged-kv and
--continuous-batching) splits each LLM into prefill-specialist and
decode-specialist replicas (--prefill-replicas/--decode-replicas,
default 1+1): prompts prefill at full token budget with no co-resident
decodes, then the scheduler's two-stage dispatch migrates each
sequence's paged KV blocks into a decode replica's pool
(export_seq/import_seq over the migrate_blocks primitive) and admits it
into that replica's continuous loop — prefill/decode interference is
removed entirely instead of time-sliced; outputs stay token-identical
to unified serving.
--slo-sched (requires --continuous-batching) arms SLO-aware
multi-tenant scheduling on every LLM replica: queries are stamped with
an SLO class (interactive vs batch, alternating here) and a tenant
identity; each replica's continuous loop then admits by
(class, priority, e-graph depth, arrival) rank with an --slo-aging
starvation bound, enforces weighted max-min fair shares of decode
slots and KV blocks per tenant, and under pressure preempts a batch
sequence via evict-to-recompute (paged KV freed, continuation replayed
token-identically on re-admission). Per-tenant/per-class stats print at
exit.
--fault-inject / --request-deadline / --max-retries enable the
fault-tolerance layer (requires --continuous-batching): a seeded
deterministic FaultInjector crashes/hangs/slows replicas at exact call
indices, the pool tracks replica health (suspect/dead) via a watchdog,
dead replicas' KV blocks are reclaimed, and in-flight sequences are
replayed onto healthy replicas via evict-to-recompute — greedy decode
makes the recovered output token-identical. Requests past the deadline
fail with a structured error instead of hanging.
--overload-control (requires --scheme Teola and --continuous-batching)
arms the overload-control/graceful-degradation layer: per-query
deadlines (--query-deadline) decomposed along the e-graph into
per-primitive budgets, front-door load shedding against the estimated
pool queue delay (--shed-queue-tokens; interactive queries keep a
protected share), hedged dispatch of idempotent encoder/search
primitives onto a second healthy replica (--hedge-after; needs pooled
encoders, --encoder-instances 2 with --sim), and a brown-out
degradation ladder (--degrade) that activates per-node degrade
annotations — shrink top_k, skip rerank, halve max_new, cap prefill
chunks — stepwise with hysteresis. Shed queries fail fast with a
structured Overloaded error; all knobs off is byte-identical to the
layer absent.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.apps import ALL_APPS, build_engines
from repro_torch.core.engine_pool import build_pools, disaggregate_pools
from repro_torch.core.teola import AutoGenLike, LlamaDist, LlamaDistPC, Teola
from repro_torch.training.data import doc_corpus

SCHEMES = {
    "Teola": (Teola, "topo"),
    "LlamaDist-PO": (LlamaDist, "po"),
    "LlamaDist-TO": (LlamaDist, "to"),
    "LlamaDistPC-TO": (LlamaDistPC, "to"),
    "AutoGen-TO": (AutoGenLike, "to"),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", default="advanced_rag", choices=ALL_APPS)
    ap.add_argument("--scheme", default="Teola", choices=SCHEMES)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--sim", action="store_true",
                    help="paper-calibrated latency-profile engines")
    ap.add_argument("--llm-instances", type=int, default=1,
                    help="EnginePool replicas per LLM engine")
    ap.add_argument("--streaming", action="store_true",
                    help="stream decode chunks to downstream primitives")
    ap.add_argument("--continuous-batching", action="store_true",
                    help="iteration-level decode batching (persistent "
                         "decode loop with per-iteration admission)")
    ap.add_argument("--paged-kv", action="store_true",
                    help="block-paged KV cache: COW prefix sharing, "
                         "block-table decode, block-based occupancy "
                         "routing with pool backpressure")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="stall-free chunked prefill: prompts advance in "
                         "bounded chunks between decode iterations under "
                         "a per-pass token budget (requires "
                         "--continuous-batching)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="tokens per prefill chunk (default 128; requires "
                         "--chunked-prefill)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-iteration token budget shared by decode and "
                         "prefill tokens (default: decode slots + one "
                         "chunk; requires --chunked-prefill)")
    ap.add_argument("--prefix-cache", choices=("none", "radix"),
                    default="none",
                    help="global radix-tree prefix cache: any shared "
                         "block-aligned prompt prefix reuses cached KV "
                         "blocks across queries, with LRU leaf eviction "
                         "(requires --paged-kv)")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-verify speculative decoding on core_llm "
                         "(token-identical greedy outputs, fewer target "
                         "steps per token)")
    ap.add_argument("--draft-k", type=int, default=None,
                    help="draft tokens per verification step (default 4; "
                         "requires --speculative)")
    ap.add_argument("--spec-drafter", choices=("ngram", "lite_llm"),
                    default=None,
                    help="drafter: model-free prompt lookup (default) or "
                         "the co-located lite_llm replica (requires "
                         "--speculative)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="role-specialized LLM pools: prefill-specialist "
                         "replicas run prompts at full token budget, "
                         "completed sequences migrate their paged KV "
                         "blocks to decode-specialist replicas' loops "
                         "(requires --paged-kv and --continuous-batching)")
    ap.add_argument("--prefill-replicas", type=int, default=None,
                    help="prefill-specialist replicas per LLM pool "
                         "(default 1; requires --disaggregate)")
    ap.add_argument("--decode-replicas", type=int, default=None,
                    help="decode-specialist replicas per LLM pool "
                         "(default 1; requires --disaggregate)")
    ap.add_argument("--slo-sched", action="store_true",
                    help="SLO-aware multi-tenant scheduling: priority "
                         "admission by (class, priority, depth, arrival), "
                         "per-tenant fair-share decode slots / KV blocks, "
                         "paged preemption of batch work under pressure "
                         "(requires --continuous-batching)")
    ap.add_argument("--slo-aging", type=float, default=None,
                    metavar="SECONDS",
                    help="starvation bound: a batch-class item older than "
                         "this ranks as urgent (default 5.0; requires "
                         "--slo-sched)")
    ap.add_argument("--fault-inject", default=None, metavar="SPEC",
                    help="deterministic fault schedule, comma-separated "
                         "kind:engine:point:at[:duration[:width]] entries, "
                         "e.g. crash:core_llm.r1:decode:3 — kinds: crash, "
                         "hang, slow, burst, migrate_fail, alloc_fail; "
                         "implies fault tolerance (requires --continuous-"
                         "batching)")
    ap.add_argument("--request-deadline", type=float, default=None,
                    metavar="SECONDS",
                    help="per-request deadline: an in-flight request past "
                         "it fails with a structured DeadlineExceeded "
                         "instead of hanging (enables fault tolerance)")
    ap.add_argument("--max-retries", type=int, default=None,
                    help="recovery attempts per request before failing "
                         "loudly (default 2; enables fault tolerance)")
    ap.add_argument("--overload-control", action="store_true",
                    help="overload control + graceful degradation: "
                         "deadline propagation, admission control, hedged "
                         "dispatch, brown-out ladder (requires --scheme "
                         "Teola and --continuous-batching)")
    ap.add_argument("--query-deadline", type=float, default=None,
                    metavar="SECONDS",
                    help="per-query end-to-end deadline, decomposed into "
                         "per-primitive budgets along the e-graph "
                         "(requires --overload-control)")
    ap.add_argument("--shed-queue-tokens", type=float, default=None,
                    help="admission control: shed batch queries when the "
                         "estimated engine backlog exceeds this many "
                         "tokens; interactive queries get a 3x allowance "
                         "(requires --overload-control)")
    ap.add_argument("--hedge-after", type=float, default=None,
                    metavar="SECONDS",
                    help="hedged dispatch: send a backup for idempotent "
                         "encoder/search batches still unfinished after "
                         "this delay, first result wins (requires "
                         "--overload-control and a second replica)")
    ap.add_argument("--degrade", action="store_true",
                    help="brown-out degradation ladder: under deadline "
                         "pressure activate per-node degrade annotations "
                         "stepwise (requires --overload-control and "
                         "--query-deadline)")
    ap.add_argument("--encoder-instances", type=int, default=None,
                    help="EnginePool replicas for the embedding/rerank "
                         "encoders (sim engines only; default 1, use 2+ "
                         "to give hedged dispatch a backup target)")
    ap.add_argument("--device", default="cuda",
                    help="device of the real engines' weights and caches "
                         "(default cuda; cpu runs the kernels' plain "
                         "versions)")
    return ap


def validate_args(ap: argparse.ArgumentParser, args) -> None:
    """Reject incompatible flag combinations with a clear argparse error
    (exit code 2 + usage) instead of a deep runtime stack trace. Fills in
    speculative defaults after validation."""
    if args.prefill_chunk is not None and not args.chunked_prefill:
        ap.error("--prefill-chunk requires --chunked-prefill")
    if args.token_budget is not None and not args.chunked_prefill:
        ap.error("--token-budget requires --chunked-prefill")
    if args.chunked_prefill:
        if args.scheme != "Teola":
            ap.error("--chunked-prefill requires --scheme Teola (baseline "
                     "orchestrators drive monolithic prefill batches "
                     "outside the continuous loop)")
        if not args.continuous_batching:
            ap.error("--chunked-prefill requires --continuous-batching "
                     "(prefill chunks are packed into the persistent "
                     "decode loop's mixed iterations)")
        if args.prefill_chunk is not None and args.prefill_chunk < 1:
            ap.error(f"--prefill-chunk must be >= 1, got "
                     f"{args.prefill_chunk}")
        if args.token_budget is not None and args.token_budget < 1:
            ap.error(f"--token-budget must be >= 1, got "
                     f"{args.token_budget}")
    args.prefill_chunk = args.prefill_chunk if args.prefill_chunk \
        is not None else 128
    if args.prefix_cache == "radix" and not args.paged_kv:
        ap.error("--prefix-cache radix requires --paged-kv (cached "
                 "prefixes live in the refcounted block pool)")
    if args.draft_k is not None and not args.speculative:
        ap.error("--draft-k requires --speculative")
    if args.spec_drafter is not None and not args.speculative:
        ap.error("--spec-drafter requires --speculative")
    if args.speculative:
        if args.scheme != "Teola":
            ap.error("--speculative requires --scheme Teola (baseline "
                     "orchestrators drive run-to-completion decode "
                     "batches outside the speculative decode loop)")
        if not args.continuous_batching:
            ap.error("--speculative requires --continuous-batching (the "
                     "speculative path runs inside each replica's "
                     "persistent decode loop)")
        if args.draft_k is not None and args.draft_k < 1:
            ap.error(f"--draft-k must be >= 1, got {args.draft_k}")
        if args.sim and args.spec_drafter == "lite_llm":
            ap.error("--spec-drafter lite_llm needs real engines (the "
                     "sim models speculative cost with the lite profile "
                     "already; drop --sim or use --spec-drafter ngram)")
    args.draft_k = args.draft_k if args.draft_k is not None else 4
    args.spec_drafter = args.spec_drafter or "ngram"
    if args.prefill_replicas is not None and not args.disaggregate:
        ap.error("--prefill-replicas requires --disaggregate")
    if args.decode_replicas is not None and not args.disaggregate:
        ap.error("--decode-replicas requires --disaggregate")
    if args.disaggregate:
        if args.scheme != "Teola":
            ap.error("--disaggregate requires --scheme Teola (baseline "
                     "orchestrators bypass the pooled two-stage "
                     "dispatch)")
        if not args.paged_kv:
            ap.error("--disaggregate requires --paged-kv (the handoff "
                     "migrates refcounted KV blocks between replica "
                     "pools)")
        if not args.continuous_batching:
            ap.error("--disaggregate requires --continuous-batching "
                     "(completed prefills hand off into the decode "
                     "replicas' persistent loops)")
        if args.llm_instances > 1:
            ap.error("--disaggregate and --llm-instances > 1 are "
                     "mutually exclusive (replica counts come from "
                     "--prefill-replicas/--decode-replicas)")
        if args.prefill_replicas is not None and args.prefill_replicas < 1:
            ap.error(f"--prefill-replicas must be >= 1, got "
                     f"{args.prefill_replicas}")
        if args.decode_replicas is not None and args.decode_replicas < 1:
            ap.error(f"--decode-replicas must be >= 1, got "
                     f"{args.decode_replicas}")
    args.prefill_replicas = args.prefill_replicas \
        if args.prefill_replicas is not None else 1
    args.decode_replicas = args.decode_replicas \
        if args.decode_replicas is not None else 1
    if args.slo_aging is not None and not args.slo_sched:
        ap.error("--slo-aging requires --slo-sched")
    if args.slo_sched:
        if args.scheme != "Teola":
            ap.error("--slo-sched requires --scheme Teola (the SLO "
                     "policy lives in the continuous-loop admission "
                     "pass)")
        if not args.continuous_batching:
            ap.error("--slo-sched requires --continuous-batching "
                     "(priority admission and preemption run in the "
                     "persistent decode loops)")
        if args.slo_aging is not None and args.slo_aging < 0:
            ap.error(f"--slo-aging must be >= 0, got {args.slo_aging}")
    args.slo_aging = args.slo_aging if args.slo_aging is not None else 5.0
    ft_on = (args.fault_inject is not None
             or args.request_deadline is not None
             or args.max_retries is not None)
    if ft_on:
        if args.scheme != "Teola":
            ap.error("fault-tolerance flags require --scheme Teola "
                     "(recovery lives in the pooled two-tier scheduler)")
        if not args.continuous_batching:
            ap.error("fault-tolerance flags require --continuous-batching "
                     "(recovery replays sequences through the persistent "
                     "decode loops)")
        if args.request_deadline is not None and args.request_deadline <= 0:
            ap.error(f"--request-deadline must be > 0, got "
                     f"{args.request_deadline}")
        if args.max_retries is not None and args.max_retries < 0:
            ap.error(f"--max-retries must be >= 0, got {args.max_retries}")
        if args.fault_inject is not None:
            from repro_torch.serving.faults import FaultInjector
            try:
                FaultInjector.parse(args.fault_inject)
            except ValueError as e:
                ap.error(f"--fault-inject: {e}")
    args.fault_tolerance_on = ft_on
    for flag, name in ((args.query_deadline, "--query-deadline"),
                       (args.shed_queue_tokens, "--shed-queue-tokens"),
                       (args.hedge_after, "--hedge-after")):
        if flag is not None and not args.overload_control:
            ap.error(f"{name} requires --overload-control")
    if args.degrade and not args.overload_control:
        ap.error("--degrade requires --overload-control")
    if args.overload_control:
        if args.scheme != "Teola":
            ap.error("--overload-control requires --scheme Teola (the "
                     "admission/degradation hooks live in the managed "
                     "runtime)")
        if not args.continuous_batching:
            ap.error("--overload-control requires --continuous-batching "
                     "(queue-delay estimation reads the pooled decode "
                     "loops' load signals)")
        if args.query_deadline is not None and args.query_deadline <= 0:
            ap.error(f"--query-deadline must be > 0, got "
                     f"{args.query_deadline}")
        if args.shed_queue_tokens is not None and args.shed_queue_tokens <= 0:
            ap.error(f"--shed-queue-tokens must be > 0, got "
                     f"{args.shed_queue_tokens}")
        if args.hedge_after is not None and args.hedge_after < 0:
            ap.error(f"--hedge-after must be >= 0, got {args.hedge_after}")
        if args.degrade and args.query_deadline is None:
            ap.error("--degrade requires --query-deadline (the brown-out "
                     "ladder steps on per-query deadline slack)")
    if args.encoder_instances is not None:
        if not args.sim:
            ap.error("--encoder-instances requires --sim (real encoder "
                     "pooling is not wired into this launcher)")
        if args.encoder_instances < 1:
            ap.error(f"--encoder-instances must be >= 1, got "
                     f"{args.encoder_instances}")
    args.encoder_instances = args.encoder_instances \
        if args.encoder_instances is not None else 1


def make_engines(args, base=None) -> dict:
    """The engine dict the flags ask for: sim engines with ``--sim``;
    otherwise ``base`` (default: ``build_engines`` on ``--device``),
    pooled, disaggregated and given speculation as the flags say."""
    if args.sim:
        from repro_torch.engines.sim_engines import build_sim_engines
        return build_sim_engines(llm_instances=args.llm_instances,
                                 paged_kv=args.paged_kv,
                                 speculative=args.speculative,
                                 draft_k=args.draft_k,
                                 chunked_prefill=args.chunked_prefill,
                                 prefill_chunk=args.prefill_chunk,
                                 token_budget=args.token_budget,
                                 prefix_cache=args.prefix_cache,
                                 disaggregate=args.disaggregate,
                                 prefill_replicas=args.prefill_replicas,
                                 decode_replicas=args.decode_replicas,
                                 encoder_instances=args.encoder_instances)
    engines = base if base is not None else build_engines(
        paged_kv=args.paged_kv, chunked_prefill=args.chunked_prefill,
        prefill_chunk=args.prefill_chunk, token_budget=args.token_budget,
        prefix_cache=args.prefix_cache, device=args.device)
    if args.llm_instances > 1:
        engines = build_pools(engines, {
            "core_llm": args.llm_instances,
            "lite_llm": args.llm_instances})
    if args.disaggregate:
        engines = disaggregate_pools(
            engines, ("core_llm", "lite_llm"),
            args.prefill_replicas, args.decode_replicas)
    if args.speculative:
        from repro_torch.engines.spec_decode import attach_speculative
        attach_speculative(
            engines,
            draft="lite_llm" if args.spec_drafter == "lite_llm"
            else None,
            k=args.draft_k)
    return engines


def serve(args, engines):
    """Arm the serving layers the flags ask for on ``engines``, serve a
    warm-up query and ``--queries`` more, print the reference's lines,
    shut down. Returns (orchestrator, the queries' contexts)."""
    if args.slo_sched:
        from repro_torch.serving.slo import attach_slo
        pols = attach_slo(engines, aging_s=args.slo_aging)
        print(f"[serve] SLO scheduling armed on {len(pols)} replicas "
              f"(aging {args.slo_aging:.1f}s)")
    ft = None
    injector = None
    if args.fault_tolerance_on:
        from repro_torch.serving.faults import FaultInjector, FTConfig
        ft = FTConfig(
            max_retries=args.max_retries if args.max_retries is not None
            else 2,
            request_deadline=args.request_deadline)
        if args.fault_inject is not None:
            injector = FaultInjector.parse(args.fault_inject, seed=0)
            armed = injector.arm(engines,
                                 encoders=args.overload_control)
            print(f"[serve] fault injector armed on {armed}")
    overload = None
    if args.overload_control:
        from repro_torch.serving.overload import (OverloadConfig,
                                                  OverloadManager)
        ov_cfg = OverloadConfig(
            deadline_s=args.query_deadline,
            shed=args.shed_queue_tokens is not None,
            max_queue_tokens=args.shed_queue_tokens
            if args.shed_queue_tokens is not None else 4096.0,
            hedge=args.hedge_after is not None,
            hedge_after_s=args.hedge_after,
            degrade=args.degrade)
        overload = OverloadManager(ov_cfg)
        print(f"[serve] overload control armed "
              f"(deadline={args.query_deadline} "
              f"shed={ov_cfg.shed} hedge={ov_cfg.hedge} "
              f"degrade={ov_cfg.degrade})")
    app = ALL_APPS[args.app](engines)
    cls, policy = SCHEMES[args.scheme]
    if cls is Teola:
        orch = cls(app, engines, policy=policy, streaming=args.streaming,
                   continuous_batching=args.continuous_batching,
                   fault_tolerance=ft, overload=overload)
    else:
        orch = cls(app, engines, policy=policy)

    try:
        docs = doc_corpus(2)
        print(f"[serve] {args.app} via {args.scheme} "
              f"({'sim' if args.sim else 'real'} engines); warmup...")
        orch.query({"question": "warmup question", "docs": docs}, timeout=600)

        rng = np.random.default_rng(0)
        ctxs = []
        t0 = time.time()
        for i in range(args.queries):
            q = {"question": f"what is fact {i} about optics", "docs": docs}
            if args.slo_sched or args.overload_control:
                # two tenants, alternating SLO classes: tenant t0 is the
                # interactive user, t1 the throughput-bound batch tenant
                ctxs.append(orch.submit(
                    q, slo="interactive" if i % 2 == 0 else "batch",
                    tenant=f"t{i % 2}"))
            else:
                ctxs.append(orch.submit(q))
            time.sleep(float(rng.exponential(1.0 / args.rate)))
        for c in ctxs:
            c.done.wait(600)
        wall = time.time() - t0
        lats = [c.latency for c in ctxs if c.t_done]
        errs = [c for c in ctxs if c.error is not None]
        print(f"[serve] {len(lats)}/{args.queries} queries in {wall:.1f}s; "
              f"avg latency {np.mean(lats) * 1000:.0f}ms "
              f"p90 {np.percentile(lats, 90) * 1000:.0f}ms"
              + (f"; {len(errs)} failed" if errs else ""))
        if ft is not None:
            for s in orch.runtime.scheds.values():
                mgr = getattr(s, "ftmgr", None)
                if mgr is not None and mgr.events:
                    print(f"[serve] recovery events ({s.pool.name}): "
                          f"{mgr.events}")
        if injector is not None and injector.log:
            print(f"[serve] injected faults: {injector.log}")
        if args.slo_sched:
            from repro_torch.serving.slo import pool_tenant_stats
            for key, row in sorted(pool_tenant_stats(engines).items()):
                print(f"[serve] tenant {key}: "
                      + " ".join(f"{k}={v}" for k, v in sorted(row.items())))
        if overload is not None:
            from repro_torch.core.engine_pool import replicas_of
            from repro_torch.serving.overload import Overloaded
            shed = sum(1 for c in ctxs if isinstance(c.error, Overloaded))
            snap = overload.snapshot()
            print(f"[serve] overload: shed={shed} "
                  f"admission={snap['admission']} hedge={snap['hedge']} "
                  f"degrade={snap['degrade']}")
            leaked = bad = 0
            for eng in engines.values():
                for inst in replicas_of(eng):
                    alloc = getattr(inst, "alloc", None)
                    if alloc is not None and hasattr(alloc, "audit"):
                        rep = alloc.audit()
                        leaked += rep["leaked"]
                        bad += rep["bad_free"]
            print(f"[serve] kv audit: leaked={leaked} bad_free={bad}")
    finally:
        orch.shutdown()
    return orch, ctxs


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    validate_args(ap, args)
    serve(args, make_engines(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
