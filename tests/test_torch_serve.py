"""The port's serve entry point (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``): the same flags plus ``--device``,
the same argparse errors for the flag combinations the reference's tests
reject (tests/test_spec_decode.py, test_radix_cache.py, test_disagg.py,
test_faults.py, test_overload.py), the same parsed values for those they
accept; ``main`` on sim engines for each app; and ``main`` on real CPU
engines in a subprocess, which must exit 0."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as rserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_DISAGG_OK = ["--disaggregate", "--paged-kv", "--continuous-batching"]

REJECT = [
    # tests/test_spec_decode.py
    (["--speculative"], "--continuous-batching"),
    (["--speculative", "--continuous-batching", "--scheme",
      "LlamaDist-TO"], "--scheme Teola"),
    (["--speculative", "--continuous-batching", "--draft-k", "0"],
     "--draft-k must be >= 1"),
    (["--draft-k", "4"], "--draft-k requires --speculative"),
    (["--spec-drafter", "ngram"], "--spec-drafter requires"),
    (["--sim", "--speculative", "--continuous-batching",
      "--spec-drafter", "lite_llm"], "real engines"),
    # tests/test_radix_cache.py
    (["--prefix-cache", "radix"], "--paged-kv"),
    # tests/test_disagg.py
    (["--prefill-replicas", "2"], "--prefill-replicas requires"),
    (["--decode-replicas", "2"], "--decode-replicas requires"),
    (["--disaggregate", "--continuous-batching"], "--paged-kv"),
    (["--disaggregate", "--paged-kv"], "--continuous-batching"),
    (_DISAGG_OK + ["--scheme", "LlamaDist-TO"], "--scheme Teola"),
    (_DISAGG_OK + ["--llm-instances", "2"], "--llm-instances"),
    (_DISAGG_OK + ["--prefill-replicas", "0"],
     "--prefill-replicas must be >= 1"),
    (_DISAGG_OK + ["--decode-replicas", "0"],
     "--decode-replicas must be >= 1"),
    # tests/test_faults.py
    (["--fault-inject", "crash:core_llm:decode:1"],
     "--continuous-batching"),
    (["--request-deadline", "5"], "--continuous-batching"),
    (["--max-retries", "3"], "--continuous-batching"),
    (["--continuous-batching", "--fault-inject", "x"], "bad fault spec"),
    (["--continuous-batching", "--fault-inject",
      "explode:core_llm:decode:1"], "unknown fault kind"),
    (["--continuous-batching", "--request-deadline", "0"],
     "--request-deadline must be > 0"),
    (["--continuous-batching", "--max-retries", "-1"],
     "--max-retries must be >= 0"),
    (["--continuous-batching", "--scheme", "LlamaDist-TO",
      "--max-retries", "1"], "--scheme Teola"),
    # tests/test_overload.py
    (["--continuous-batching", "--query-deadline", "5"],
     "--overload-control"),
    (["--continuous-batching", "--shed-queue-tokens", "64"],
     "--overload-control"),
    (["--continuous-batching", "--hedge-after", "0.1"],
     "--overload-control"),
    (["--continuous-batching", "--degrade"], "--overload-control"),
    (["--overload-control"], "--continuous-batching"),
    (["--continuous-batching", "--overload-control",
      "--query-deadline", "0"], "--query-deadline must be > 0"),
    (["--continuous-batching", "--overload-control", "--degrade"],
     "--degrade requires --query-deadline"),
    (["--encoder-instances", "2"], "--sim"),
    # --slo-sched (serve.py's own rules)
    (["--slo-sched"], "--continuous-batching"),
    (["--slo-aging", "1"], "--slo-aging requires --slo-sched"),
    (["--slo-sched", "--continuous-batching", "--scheme", "AutoGen-TO"],
     "--scheme Teola"),
]

ACCEPT = [
    [],
    ["--speculative", "--continuous-batching"],
    ["--speculative", "--continuous-batching", "--draft-k", "6",
     "--spec-drafter", "lite_llm"],
    ["--prefix-cache", "radix", "--paged-kv"],
    _DISAGG_OK,
    _DISAGG_OK + ["--prefill-replicas", "2", "--decode-replicas", "3"],
    ["--continuous-batching", "--fault-inject",
     "crash:core_llm.r1:decode:3", "--request-deadline", "10",
     "--max-retries", "1"],
    ["--sim", "--continuous-batching", "--overload-control",
     "--query-deadline", "5", "--shed-queue-tokens", "256",
     "--hedge-after", "0.05", "--degrade", "--encoder-instances", "2"],
    ["--continuous-batching", "--paged-kv", "--slo-sched",
     "--slo-aging", "2.5"],
    ["--continuous-batching", "--chunked-prefill", "--prefill-chunk", "64",
     "--token-budget", "80"],
]


def _validate(mod, argv):
    ap = mod.build_parser()
    args = ap.parse_args(argv)
    mod.validate_args(ap, args)
    return args


def test_same_flags_plus_device():
    def flags(mod):
        return {a.dest: (a.option_strings, a.default,
                         sorted(a.choices) if a.choices else None, a.help)
                for a in mod.build_parser()._actions}
    port, ref = flags(tserve), flags(rserve)
    assert port.pop("device")[:3] == (["--device"], "cuda", None)
    assert port == ref
    assert tserve.SCHEMES.keys() == rserve.SCHEMES.keys()


@pytest.mark.parametrize("argv,msg", REJECT)
def test_serve_rejects_what_the_reference_rejects(argv, msg, capsys):
    errs = []
    for mod in (rserve, tserve):
        with pytest.raises(SystemExit) as e:
            _validate(mod, argv)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err)
    assert msg in errs[1]
    assert errs[1].splitlines()[-1] == errs[0].splitlines()[-1]


@pytest.mark.parametrize("argv", ACCEPT, ids=lambda a: " ".join(a) or "-")
def test_serve_accepts_what_the_reference_accepts(argv):
    port = vars(_validate(tserve, argv))
    assert port.pop("device") == "cuda"
    assert port == vars(_validate(rserve, argv))


@pytest.mark.parametrize("app", sorted(tserve.ALL_APPS))
def test_main_on_sim_engines(app, capsys):
    assert tserve.main(["--app", app, "--sim", "--queries", "2",
                        "--rate", "50"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {app} via Teola (sim engines); warmup..." in out
    assert "[serve] 2/2 queries in" in out and "failed" not in out


def test_main_on_sim_engines_with_every_serving_layer(capsys):
    """SLO scheduling, fault injection with recovery, and overload control
    armed together on sim engine pools (the reference's own sim
    combination)."""
    assert tserve.main([
        "--app", "naive_rag", "--sim", "--queries", "4", "--rate", "50",
        "--llm-instances", "2", "--continuous-batching", "--paged-kv",
        "--slo-sched", "--fault-inject", "crash:core_llm.r1:decode:2",
        "--overload-control", "--query-deadline", "30"]) == 0
    out = capsys.readouterr().out
    assert "[serve] SLO scheduling armed on 4 replicas" in out
    assert "[serve] fault injector armed on" in out
    assert "[serve] 4/4 queries in" in out and "failed" not in out
    assert "[serve] kv audit: leaked=0 bad_free=0" in out


@pytest.mark.parametrize("argv", [
    ["--app", "naive_rag"],
    ["--app", "advanced_rag", "--scheme", "LlamaDistPC-TO"],
], ids=["naive_rag-Teola", "advanced_rag-LlamaDistPC-TO"])
def test_main_on_real_cpu_engines_exits_cleanly(argv):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv,
         "--queries", "1", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert "terminate called" not in proc.stderr, proc.stderr
    assert proc.returncode == 0, proc.stderr
    assert "(real engines); warmup..." in proc.stdout
    assert "[serve] 1/1 queries in" in proc.stdout, proc.stdout
