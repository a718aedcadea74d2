"""A tiny copy of the benchmark for the CPU tests: reduced configurations
of the real ones, the real mix's parameters at a load a CPU holds, and
the real metric readers."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# the configuration files the reduced ones are cut from
QWEN = BENCH / "configs" / "qwen1.5-moe-a2.7b-dense.json"
RWKV = BENCH / "configs" / "rwkv6-3b.json"

# CPU sizes: the port's reduced() variants (2 layers, d 256, vocab 1024)
TINY = {
    "tiny-qwen": {"program_config": "qwen2-moe-a2.7b", "program_reduce": {},
                  "architecture": "qwen2_moe", "hidden_size": 256,
                  "num_hidden_layers": 2, "num_attention_heads": 4,
                  "num_key_value_heads": 4, "head_dim": 64,
                  "intermediate_size": 512, "moe_intermediate_size": 128,
                  "shared_expert_intermediate_size": 128, "num_experts": 4,
                  "num_experts_per_tok": 2, "norm_topk_prob": False,
                  "vocab_size": 1024, "rope_theta": 1000000.0,
                  "rms_norm_eps": 1e-06},
    "tiny-rwkv": {"program_config": "rwkv6-3b", "program_reduce": {},
                  "architecture": "rwkv6", "hidden_size": 256,
                  "num_hidden_layers": 2, "head_size": 32, "lora_rank": 8,
                  "intermediate_size": 512, "vocab_size": 1024,
                  "rms_norm_eps": 1e-05},
}
# limits of the CPU runs: the port's plain CPU path against the reference,
# both float32 on one CPU, differ by summation order only
CPU_LIMITS = {"token_gap_mean": 1e-4, "embed_err": 1e-5, "retrieval_err": 1e-5,
              "rerank_err": 1e-4}


def tiny_tree(tmp: Path, rate: float = 1.5, max_batch: int = 4) -> Path:
    """A benchmark tree under ``tmp``: BENCHMARK.json with one cell,
    ``tiny-qwen.steady``, on the reduced Qwen configuration, the real
    readers, and the real mix at a rate a CPU holds."""
    bench = tmp / "bench"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    (bench / "traffic").mkdir(parents=True)
    (bench / "configs").mkdir()
    mix = json.loads((BENCH / "traffic" / "adv-rag.steady.json").read_text())
    mix["rate_qps"], mix["drain_s"] = rate, 60
    (bench / "traffic" / "adv-rag.steady.json").write_text(json.dumps(mix))
    conf = dict(json.loads(QWEN.read_text()), name="tiny-qwen",
                **TINY["tiny-qwen"], limits=dict(CPU_LIMITS))
    conf["serving"] = dict(conf["serving"], max_batch=max_batch)
    (bench / "configs" / "tiny-qwen.json").write_text(json.dumps(conf))
    cell = "tiny-qwen.steady"
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench_json.update(
        configs=[{"name": "tiny-qwen", "source": conf["source"],
                  "file": "bench/configs/tiny-qwen.json", "reduced": [],
                  "why": "CPU test"}],
        workloads=[{"name": cell, "config": "tiny-qwen",
                    "traffic": "adv-rag.steady", "chips": 1,
                    "why": "CPU test"}])
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cell]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench_json))
    return bench
