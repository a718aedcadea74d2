"""Whole runs of the harness on the CPU at the reduced sizes of the
benchmark's configuration (the dense KV path; the look for a card
skipped): ``correct`` true on the port as it is, false on the control
(the port's bfloat16 path) and with the timed path broken underneath: a
token altered where it is produced, a step that leaves the KV state
unchanged, half of a decode batch left out. One chip only, so no cell has
an exchange between chips to leave out."""
import json
import subprocess
import sys
import time

import pytest
import torch

from .benchtree import BENCH, ROOT, tiny_tree
from harness import runner

SECONDS = 6.0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    return tmp, tiny_tree(tmp)


def _run(tree, cell, seed=2 ** 31 + 99, trace=False, precision="float32"):
    tmp, bench = tree
    return runner.run(tmp, bench, cell, seed, SECONDS, trace, time.time(),
                      device="cpu", precision=precision)


def _line(out, trace):
    import importlib.util
    spec = importlib.util.spec_from_file_location("bench_run",
                                                  BENCH / "run.py")
    run_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_mod)

    class Args:
        pass
    Args.trace = int(trace)
    return run_mod.result_line(out, Args, {"platform": "cpu"})


@pytest.mark.parametrize("cell,trace,want", [
    ("tiny-qwen.steady", False, {"setup_s", "query_p50_s"}),
    ("tiny-qwen.steady", True, {"orch_gap_ms.steady",
                                "decode_step_ms.steady",
                                "model_mfu.steady",
                                "device_idle_share.steady"})])
def test_run_is_correct(tree, cell, trace, want):
    out = _run(tree, cell, trace=trace)
    line = _line(out, trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "checks"
    assert {"token_gap_mean", "embed_err", "retrieval_err", "rerank_err",
            "failed_queries"} == set(line["checks"])
    json.dumps(line)


def _argmax_moved(orig):
    """The decode step's logits favour the token after its best one."""
    def step(self, *a, **k):
        logits, cache = orig(self, *a, **k)
        out = logits.clone()
        top = logits.argmax(-1)
        out[torch.arange(len(top)), (top + 1) % logits.shape[-1]] += 1e3
        return out, cache
    return step


def _half_left_out(orig):
    """The decode step computes the first half of its batch's rows."""
    def step(self, *a, **k):
        logits, cache = orig(self, *a, **k)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0.0
        return logits, cache
    return step


def _kv_unchanged(orig):
    """The KV write returns the cache as it was."""
    def write(buf, chunk, pos, seq=None):
        return buf
    return write


FAULTS = {
    "token_altered": ("repro_torch.engines.llm_engine.LLMEngine", "_step",
                      _argmax_moved),
    "half_batch_left_out": ("repro_torch.engines.llm_engine.LLMEngine",
                            "_step", _half_left_out),
    "state_unchanged": ("repro_torch.serving.kv_cache", "write_linear",
                        _kv_unchanged),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(tree, monkeypatch, fault):
    import importlib
    where, name, make = FAULTS[fault]
    mod_name, _, cls = where.rpartition(".") if where.endswith(
        "LLMEngine") else (where, None, None)
    owner = importlib.import_module(mod_name)
    if cls:
        owner = getattr(owner, cls)
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    out = _run(tree, "tiny-qwen.steady")
    assert not out["correct"]
    got = {k: v for k, v, _ in out["numbers"]}
    # wrong tokens read far above the limit; a token the tokenizer drops
    # (id 0 from zeroed logits) can leave an answer empty, a failed query
    assert got.get("token_gap_mean", 0.0) > 10 * 1e-4 or got["failed_queries"]


def test_control_is_not_correct(tree):
    """The control: the port's bfloat16 path serves, the reference in
    bfloat16 stands in for the encoders. The served tokens and the
    vectors read above their limits; a choice of chunks may still agree
    with the float32 reference's at this size."""
    out = _run(tree, "tiny-qwen.steady", precision="bfloat16")
    assert not out["correct"]
    got = {k: v for k, v, _ in out["numbers"]}
    lim = {k: lim for k, _, lim in out["numbers"]}
    for k in ("token_gap_mean", "embed_err"):
        assert got[k] > lim[k], (k, got[k], lim[k])


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "qwen-moe-dense.adv-rag.steady", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_first_cell_on_the_card(cuda_card):
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "qwen-moe-dense.adv-rag.steady", "--seed", "2",
                        "--seconds", "10", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
