#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port of Teola (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, on the card of the machine it is
started on: set-up (weights drawn on the card from the seed, engines,
warm-up), the measured window, the drain of an open loop, then the
comparison with the plain reference that decides ``correct``. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed`` (queries), ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared beside its limit, which the last lines of standard error repeat.

``--precision bfloat16`` serves the core LLM on bfloat16 weights (the
port's own lower-precision path) and puts the reference, computed in
bfloat16, in the encoders' place: the control that the comparison has to
fail. The benchmark's own runs never pass it.

Exits non-zero with no result line without a CUDA card (or with fewer
than the cell asks for), without the port's sources beside it, or if
``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded once the window has
closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
KERNELS = ROOT / "build" / "kernels"     # where the port builds its kernels
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# one process with few threads: no CPU thread pool spins beside the
# host thread that launches the card's work
THREAD_POOLS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--precision", choices=("float32", "bfloat16"),
                    default="float32")
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def result_line(out: dict, args, device: dict) -> dict:
    """The last line: the cell's metrics by the readers, the device, and
    the numbers compared (last)."""
    cell = out["cell"]
    metrics = cell["per_layer"] if args.trace else cell["end_to_end"]
    values = {}
    for m in metrics:
        v = cell["readers"][m["name"]](out["run"])
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": values, "device": device}
    sl = out["run"]["slice"]
    if args.trace and sl is not None:
        device["busy_s"] = sl["summary"]["busy_s"]
        device["window_s"] = sl["seconds"]
        line["breakdown"] = {"device_ops": sl["summary"]["device_ops"],
                             "idle_gaps": sl["summary"]["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, v, lim in out["numbers"]}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    _cache_dirs()
    for var in THREAD_POOLS:
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(BENCH))
    import torch
    from harness import cells, runner
    chips = cells.load(ROOT, BENCH, args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails without the port's sources)
    had = set(KERNELS.glob("*.so"))
    out = runner.run(ROOT, BENCH, args.workload, args.seed, args.seconds,
                     bool(args.trace), T_PROCESS, precision=args.precision)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = result_line(out, args, device)
    built = sorted(p.name for p in set(KERNELS.glob("*.so")) - had)
    if built:
        print(f"[bench] this run built {len(built)} kernel libraries into "
              f"{KERNELS.relative_to(ROOT)}: its setup_s holds the build "
              f"(a checkout's first run)", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"bench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    run = out["run"]
    late = [q["submit"] - q["sched"] for q in run["queries"]]
    print(f"[bench] {args.workload} seed {args.seed}: "
          f"{line['attempted']} queries sent, {line['failed']} failed; "
          f"the generator ran late by at most {max(late, default=0):.4f} s "
          f"(mean {sum(late) / max(1, len(late)):.4f} s)", flush=True)
    lat = [q["latency_s"] for q in run["queries"]]
    steps = sum(s for _, _, _, s in run["decode_spans"])
    step_ms = 1e3 * sum(b - a for a, b, _, _ in run["decode_spans"]) / \
        max(1, steps)
    print(f"[bench] latencies by send (s): "
          f"{[None if x is None else round(x, 3) for x in lat]}; decode: "
          f"{steps} steps of {step_ms:.1f} ms", file=sys.stderr)
    errors = Counter(q["error"] for q in run["queries"] if q["error"])
    if errors:
        print(f"[bench] query errors: {dict(errors)}", file=sys.stderr)
    print(f"[bench] correct: {line['correct']}", file=sys.stderr)
    for k, v, lim in out["numbers"]:
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
