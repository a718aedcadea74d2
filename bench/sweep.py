#!/usr/bin/env python3
"""Latency against offered rate for an open-loop cell: a sweep on the card.

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --rates 0.1,0.2,0.4 [--repeats 2]

stands the cell's system up once, then sends the cell's traffic at each
rate (queries/s) in turn for ``--seconds`` (``--repeats`` windows a rate,
each on another seed), waits for every query to be answered (at most
120 s), and prints one JSON line per window: queries sent, answered
inside the window, the latency's median, 90th percentile and mean from
the scheduled send, and the median latency of the queries sent in the
window's first and last thirds. ``sustained``: every query answered and
the last third's median at most 1.25 times the first third's (the
backlog does not grow); where one query takes a third of the window this
test cannot tell (PERF.md). The mix's ``rate_qps`` is set by hand.
"""
from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def one_rate(teola, traffic, seconds):
    from harness import window
    offsets = traffic.open_schedule(seconds)
    queries = traffic.queries(len(offsets))
    t0, t_close, t_end, recs = window.open_loop(teola, queries, offsets,
                                                seconds, 120.0)
    rows = window.summarize(recs, t0, t_end, False)
    lat = [r["latency_s"] for r in rows if r["ok"]]
    third = seconds / 3

    def med(lo, hi):
        xs = [r["latency_s"] for r in rows if r["ok"]
              and lo <= r["sched"] - t0 < hi]
        return statistics.median(xs) if xs else None
    first, last = med(0, third), med(2 * third, seconds)
    from harness.stats import percentile
    return {"sent": len(rows), "answered": len(lat),
            "answered_in_window": sum(1 for r in rows if r["ok"]
                                      and r["done"] <= t_close),
            "p50_s": percentile(lat, 50) if lat else None,
            "p90_s": percentile(lat, 90) if lat else None,
            "mean_s": statistics.fmean(lat) if lat else None,
            "first_third_p50_s": first, "last_third_p50_s": last,
            "sustained": bool(lat) and len(lat) == len(rows)
            and first is not None and last is not None
            and last <= 1.25 * first}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"          # as bench/run.py
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(BENCH))
    import torch
    from harness import cells, runner, system
    from harness.traffic import Traffic
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    c = cells.load(ROOT, BENCH, args.workload)
    conf, mix = c["conf"], c["mix"]
    teola, engines, _, _ = system.build(conf, mix, args.seed, "cuda")
    try:
        runner.warm_up(teola, engines["core_llm"], Traffic(mix, args.seed),
                       conf["serving"]["max_batch"])
        print(f"[sweep] set-up {time.time() - T_PROCESS:.1f} s", flush=True)
        unsustained = 0
        rates = [float(r) for r in args.rates.split(",")]
        for i, rate in enumerate(rates):
            rows = [dict(rate_qps=rate, **one_rate(
                teola, Traffic(dict(mix, rate_qps=rate),
                               args.seed + i * args.repeats + j),
                args.seconds)) for j in range(args.repeats)]
            for row in rows:
                print(json.dumps(row), flush=True)
            unsustained += not all(row["sustained"] for row in rows)
            if unsustained >= 2:
                break
    finally:
        teola.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
