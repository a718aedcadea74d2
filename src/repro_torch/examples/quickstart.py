"""Quickstart (the port's counterpart of ``examples/quickstart.py``):
build an app from the template API, optimize one query's graph, and run
it end-to-end on the port's engines.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda|cpu]

Runs on the card unless ``--device cpu``.
"""
import argparse
import time

from repro_torch.core.apps import build_engines, naive_rag
from repro_torch.core.teola import Teola
from repro_torch.training.data import doc_corpus


def main(device="cuda"):
    print(f"building engines (tiny PyTorch models on {device})...")
    engines = build_engines(device=device)
    app = naive_rag(engines)
    teola = Teola(app, engines)

    query = {"question": "what is fact 3 about optics",
             "docs": doc_corpus(2)}

    g = teola.build_egraph(query)
    print(f"\noptimized e-graph: {len(g.nodes)} primitives")
    for n in sorted(g.nodes.values(), key=lambda n: -n.depth):
        print(f"  depth={n.depth:2d} {n.op:20s} engine={n.engine:10s} "
              f"component={n.component}")

    try:
        print("\nwarmup (kernel builds, allocator)...")
        teola.query(dict(query), timeout=300)

        t0 = time.time()
        answer, ctx = teola.query(dict(query), timeout=300)
        print(f"\nanswer tokens: {answer!r}")
        print(f"end-to-end latency: {(time.time() - t0) * 1000:.1f} ms")
        print(f"retrieved context: "
              f"{[c['text'][:40] for c in ctx.store.get('retrieved', [])][:2]}")
    finally:
        teola.shutdown()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
