"""Co-located applications (paper §7.2; the port's counterpart of
``examples/colocated_apps.py``): naive-RAG QA and search-engine
generation sharing one engine pool, orchestrated by Teola simultaneously.

  PYTHONPATH=src python -m repro_torch.examples.colocated_apps \
      [--device cuda|cpu]

Runs on the card unless ``--device cpu``. Returns each app's answers.
"""
import argparse
import time

import numpy as np

from repro_torch.core.apps import build_engines, naive_rag, search_gen
from repro_torch.core.teola import Teola
from repro_torch.training.data import doc_corpus


def main(device="cuda"):
    engines = build_engines(device=device)
    rag = Teola(naive_rag(engines), engines)
    sg = Teola(search_gen(engines), engines)
    docs = doc_corpus(2)
    answers = {}
    try:
        print("warmup...")
        rag.query({"question": "warmup q", "docs": docs}, timeout=300)
        sg.query({"question": "warmup q"}, timeout=300)

        print("submitting interleaved queries from both apps...")
        ctxs = {"rag": [], "search_gen": []}
        for i in range(3):
            ctxs["rag"].append(rag.submit(
                {"question": f"what is fact {i} about optics", "docs": docs}))
            ctxs["search_gen"].append(sg.submit(
                {"question": f"who discovered fact {i}"}))
            time.sleep(0.1)
        for k, cs in ctxs.items():
            for c in cs:
                if not c.done.wait(600):
                    raise TimeoutError(f"{k} query {c.qid} timed out")
                if c.error is not None:
                    raise c.error
            lat = [c.latency for c in cs]
            answers[k] = [c.store.get("answer") for c in cs]
            print(f"{k:12s} avg latency {np.mean(lat) * 1000:.0f}ms "
                  f"({len(cs)} queries)")
    finally:
        rag.shutdown()
        sg.shutdown()
    return answers


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
