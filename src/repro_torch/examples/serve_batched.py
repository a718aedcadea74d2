"""End-to-end serving of concurrent requests (the port's counterpart of
``examples/serve_batched.py``): serve the advanced-RAG app on the port's
engines with a stream of batched concurrent requests.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched [n_queries] \
      [--device cuda|cpu]

Runs on the card unless ``--device cpu``. The window runs with the port's
tracer on (``repro_torch.tracing``): the core LLM's busy seconds are the
union of its ``batch`` and ``llm.*`` spans.
"""
import argparse
import time

import numpy as np

from repro_torch import tracing
from repro_torch.core.apps import advanced_rag, build_engines
from repro_torch.core.teola import Teola
from repro_torch.training.data import doc_corpus

QUESTIONS = [
    "what is fact 3 about optics",
    "tell me fact 7 about finance",
    "what is fact 5 about biology",
    "explain fact 9 about chess",
]


def main(n=6, device="cuda"):
    engines = build_engines(device=device)
    app = advanced_rag(engines)
    teola = Teola(app, engines)
    docs = doc_corpus(2)
    try:
        print("warmup...")
        teola.query({"question": QUESTIONS[0], "docs": docs}, timeout=300)

        print(f"submitting {n} concurrent queries (Poisson arrivals)...")
        rng = np.random.default_rng(0)
        ctxs = []
        tracing.enable()
        t0 = time.time()
        for i in range(n):
            q = {"question": QUESTIONS[i % len(QUESTIONS)], "docs": docs}
            ctxs.append(teola.submit(q))
            time.sleep(float(rng.exponential(0.3)))
        for c in ctxs:
            if not c.done.wait(600):
                raise TimeoutError(f"query {c.qid} timed out")
            if c.error is not None:
                raise c.error
        wall = time.time() - t0
        tracing.disable()
        spans = tracing.drain()["records"]

        lats = [c.latency for c in ctxs]
        print(f"\nserved {n} queries in {wall:.1f}s "
              f"(throughput {n / wall:.2f} q/s)")
        print(f"latency avg={np.mean(lats) * 1000:.0f}ms "
              f"p50={np.percentile(lats, 50) * 1000:.0f}ms "
              f"max={np.max(lats) * 1000:.0f}ms")
        llm = engines["core_llm"]
        busy = tracing.busy_seconds(spans).get(llm.name, 0.0)
        print(f"core LLM engine: {llm.stats['calls']} batched calls, "
              f"{llm.stats['prefill_tokens']} prefill tokens, "
              f"{llm.stats['decode_tokens']} decoded tokens, "
              f"busy {busy:.1f}s in the window")
        sched = teola.runtime.scheds["core_llm"]
        sizes = [s for s, _ in sched.batches]
        print(f"LLM batch sizes formed by topology-aware batching: "
              f"avg={np.mean(sizes):.2f} max={max(sizes)}")
    finally:
        tracing.disable()
        teola.shutdown()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n, args.device)
