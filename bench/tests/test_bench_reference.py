"""The plain reference against the port on the CPU at a 2-layer cut of each
configuration, on the weights the benchmark draws; and the import rule:
nothing under bench/ loads jax, jaxlib, flax or repro, and the yardstick
loads nothing of repro_torch."""
import ast
import json

import pytest
import torch

from .benchtree import BENCH, QWEN, RWKV, TINY
from harness import check, reference, system, weights

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: traffic, reference, comparison, work and trace arithmetic
YARDSTICK = {"traffic.py", "corpus.py", "reference.py", "check.py",
             "work.py", "trace.py", "stats.py", "weights.py", "cells.py"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    if path.parent.name == "harness" and path.name in YARDSTICK:
        assert "repro_torch" not in tops, f"{path} imports the program"


def test_the_rule_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.core\nfrom jaxtyping import x\n")
    assert {m.split(".")[0] for m in _imports(p)} & FORBIDDEN == set()
    p.write_text("import repro.core\n")
    assert {m.split(".")[0] for m in _imports(p)} & FORBIDDEN == {"repro"}


def _conf(name):
    base = json.loads((QWEN if "qwen" in name else RWKV).read_text())
    return dict(base, name=name, **TINY[name])


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_logits_match_the_ports_forward(name):
    from repro_torch.models.transformer import apply_model
    conf = _conf(name)
    cfg = system.program_config(conf)
    params = weights.decoder_params(conf, 2 ** 31 + 7, "cpu")
    toks = torch.randint(8, conf["vocab_size"], (1, 40),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got, _ = apply_model(cfg, params, toks)
    want = reference.decoder_logits(conf, params, toks[0].tolist(),
                                    kv_dtype=torch.float32)
    err = (got[0] - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.parametrize("which", ["embedding", "rerank"])
def test_reference_encoders_match_the_ports(which):
    from repro_torch.engines.encoder_engines import (EmbeddingEngine,
                                                     RerankEngine)
    conf = _conf("tiny-qwen")
    eng = (EmbeddingEngine if which == "embedding" else RerankEngine)(
        device="cpu")
    eng.params = weights.encoder_params(conf["encoders"][which], 5,
                                        1 if which == "embedding" else 2,
                                        "cpu")
    texts = ["Fact 3 about optics: value 12. Fact 4 about optics: value 9.",
             "what is fact 3 about optics [SEP] Fact 3 about optics: v 1.",
             " ".join(["word"] * 70)]
    got = eng._encode_batch(texts)
    from harness.corpus import HashTokenizer
    tok = HashTokenizer(conf["encoders"][which]["vocab_size"])
    for t, g in zip(texts, got):
        want = reference.encode(conf["encoders"][which], eng.params,
                                tok.encode(t)).numpy()
        assert abs(g - want).max() <= 1e-5


def _engine(conf, params):
    from repro_torch.engines import llm_engine
    with system._weights_for(llm_engine, params):
        return llm_engine.LLMEngine("core_llm", system.program_config(conf),
                                    max_batch=1, device="cpu")


def _served_gap(conf, params, n_prompt):
    eng = _engine(conf, params)
    toks = torch.randint(8, conf["vocab_size"], (n_prompt,),
                         generator=torch.Generator().manual_seed(3)).tolist()
    st = eng.new_state()
    eng.prefill_batch([(st, toks)])
    first = st.last_token
    out = eng.decode_batch([(st, 6)])[0]
    _, widest, n = check.token_gap(conf, params, [{"ctx": toks,
                                                   "served": [first] + out}])
    assert n == 7
    return widest


@pytest.mark.parametrize("name", sorted(TINY))
def test_served_tokens_agree_at_a_full_bucket(name):
    """A 16-token prompt fills its prefill bucket: no padding, and the
    port's served tokens are the reference's best."""
    conf = _conf(name)
    params = weights.decoder_params(conf, 11, "cpu")
    assert _served_gap(conf, params, 16) <= 1e-4


def test_qwen_served_tokens_agree_with_a_padded_prompt():
    conf = _conf("tiny-qwen")
    params = weights.decoder_params(conf, 11, "cpu")
    assert _served_gap(conf, params, 13) <= 1e-4


def _greedy(conf, params, ctx, n, pads=0):
    """The reference's n greedy tokens after ``ctx``, the state that
    decodes them having also run ``pads`` pad tokens (id 0) after the
    prompt, as a prompt padded to its bucket leaves a recurrent state."""
    def best(seq):
        return int(reference.decoder_logits(conf, params, seq,
                                            kv_dtype=torch.float32)[-1]
                   .argmax())
    out = [best(ctx)]
    while len(out) < n:
        out.append(best(list(ctx) + [0] * pads + out))
    return out


def test_rwkv_padded_prefill_fault_seen_by_the_reference():
    """The fault the RWKV cells wait for (PERF.md, Open questions): a
    13-token prompt in the 16-token bucket runs three pad tokens through
    the recurrent state, so every token decoded after the first comes
    from another state than the prompt's. The comparison sees tokens
    served so (made here by the reference itself) far from its best, and
    the same prompt's tokens served from the prompt's own state at 0."""
    conf = _conf("tiny-rwkv")
    params = weights.decoder_params(conf, 11, "cpu")
    prompt = torch.randint(8, conf["vocab_size"], (13,),
                           generator=torch.Generator().manual_seed(3)).tolist()
    gaps = [check.token_gap(conf, params, [{"ctx": prompt, "served":
                                            _greedy(conf, params, prompt, 7,
                                                    pads)}])[1]
            for pads in (0, 3)]
    assert gaps[0] <= 1e-4 and gaps[1] > 1e-2, gaps
