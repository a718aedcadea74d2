"""The port's engines against the reference engines on the same weights:
the cases of tests/test_engines.py (encoders, LLM partial prefill and
batched decode) run on both packages, which must emit identical greedy
tokens; plus the port-only surface (prefix cache, continuous decode loop,
clone, the options it does not port yet). The paged path, chunked prefill
and speculative decoding: tests/test_torch_paged.py and
tests/test_torch_chunked_spec.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.engines.encoder_engines import EmbeddingEngine  # noqa: E402
from repro.engines.encoder_engines import RerankEngine  # noqa: E402
from repro.engines.llm_engine import LLMEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.engines import encoder_engines as tenc  # noqa: E402
from repro_torch.engines.llm_engine import LLMEngine as TLLMEngine  # noqa: E402


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _llm_pair(name="tiny-lite-llm", seed=0, max_len=128):
    ref = LLMEngine("t", get_config(name), max_len=max_len, seed=seed)
    port = TLLMEngine("t", tget_config(name), max_len=max_len, device="cpu")
    port.params = bridge.decoder_params(_np_tree(ref.params),
                                        tget_config(name), "cpu")
    return ref, port


def _encoder_pair(ref_cls, port_cls):
    ref, port = ref_cls(), port_cls(device="cpu")
    port.params = bridge.encoder_params(_np_tree(ref.params), port.cfg,
                                        "cpu")
    return ref, port


def test_embedding_engine_matches_reference():
    ref, port = _encoder_pair(EmbeddingEngine, tenc.EmbeddingEngine)
    task = [{"texts": ["hello world", "optics fact"]}, {"texts": ["x y z"]}]
    r, p = ref.op_embed(task), port.op_embed(task)
    for a, b in zip(r, p):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(p[0], axis=1), 1.0, rtol=1e-3)
    assert not np.allclose(p[0][0], p[0][1])


def test_rerank_engine_matches_reference():
    ref, port = _encoder_pair(RerankEngine, tenc.RerankEngine)
    task = [{"question": "about optics",
             "candidates": [{"text": f"c{i}"} for i in range(6)],
             "top_k": 3}]
    r, p = ref.op_rerank(task)[0], port.op_rerank(task)[0]
    assert [c["text"] for c in p] == [c["text"] for c in r]
    np.testing.assert_allclose([c["rerank_score"] for c in p],
                               [c["rerank_score"] for c in r], rtol=1e-5,
                               atol=1e-5)


def test_llm_engine_partial_prefill_state_continuity():
    ref, port = _llm_pair()
    outs = []
    for eng in (ref, port):
        # split prefill: instruction then question on the same sid
        eng.op_prefill([{"sid": "a", "text": "system instruction words"}])
        assert eng.states["a"].pos == 3
        eng.op_prefill([{"sid": "a", "text": "user question here now"}])
        assert eng.states["a"].pos == 7
        out = eng.op_decode([{"sid": "a", "max_new": 4}])
        assert len(out) == 1 and isinstance(out[0], str)
        outs.append(out)
        eng.release("a")
        assert "a" not in eng.states
    assert outs[0] == outs[1]


def test_llm_engine_batched_decode_isolated_states():
    ref, port = _llm_pair()
    batch = []
    for eng in (ref, port):
        eng.op_prefill([{"sid": "x", "text": "alpha beta gamma"},
                        {"sid": "y", "text": "delta epsilon zeta eta"}])
        batch.append(eng.op_decode([{"sid": "x", "max_new": 3},
                                    {"sid": "y", "max_new": 3}]))
    assert batch[0] == batch[1]
    # batched decode must equal per-sequence decode
    _, solo = _llm_pair()
    solo.op_prefill([{"sid": "x", "text": "alpha beta gamma"}])
    assert solo.op_decode([{"sid": "x", "max_new": 3}])[0] == batch[1][0]


def test_core_llm_longer_decode_matches_reference():
    """The core LLM's GQA path (flash_prefill / decode_attention plain
    versions on the CPU): 4 sequences prefilled in one bucketed batch at
    different lengths, then 12 greedy tokens each."""
    ref, port = _llm_pair("tiny-core-llm", seed=0, max_len=256)
    texts = ["alpha beta", "gamma delta epsilon zeta eta theta",
             "one two three four five six seven eight nine ten eleven",
             "q"]
    outs = []
    for eng in (ref, port):
        eng.op_prefill([{"sid": f"s{i}", "text": t}
                        for i, t in enumerate(texts)])
        outs.append(eng.op_decode([{"sid": f"s{i}", "max_new": 12}
                                   for i in range(len(texts))]))
    assert outs[0] == outs[1]


def test_prefix_cache_fork_matches_reference():
    """Instruction-prefix reuse (LlamaDistPC): a fresh prompt that starts
    with a warmed instruction forks its KV and prefills only the rest."""
    ref, port = _llm_pair("tiny-core-llm")
    instr = "one two three four five six"
    outs = []
    for eng in (ref, port):
        eng.use_prefix_cache = True
        eng.get_prefix_state(instr)
        before = eng.stats["prefill_tokens"]
        eng.op_prefill([{"sid": "q", "text": instr + " question words"}])
        assert eng.stats["prefill_tokens"] - before == 2
        outs.append(eng.op_decode([{"sid": "q", "max_new": 5}]))
        # the cached prefix state itself is untouched by the fork's writes
        assert eng.prefix_cache[instr].pos == 6
    assert outs[0] == outs[1]


def test_continuous_decode_loop_matches_run_to_completion():
    _, port = _llm_pair("tiny-core-llm")
    _, legacy = _llm_pair("tiny-core-llm")
    prompts = {"a": "alpha beta gamma", "b": "delta epsilon"}
    for eng in (port, legacy):
        eng.op_prefill([{"sid": s, "text": t} for s, t in prompts.items()])
    want = legacy.op_decode([{"sid": s, "max_new": 5} for s in prompts])
    try:
        seqs = [port.submit_decode(s, 5) for s in prompts]
        got = [seq.wait(60) for seq in seqs]
    finally:
        port.stop_decode_loop()
    assert got == want
    assert port.stats["decode_iters"] >= 5


def test_clone_shares_weights_not_state():
    _, port = _llm_pair()
    c = port.clone(2)
    assert c.params is port.params and c.name == "t.r2"
    port.op_prefill([{"sid": "a", "text": "alpha"}])
    assert "a" not in c.states and c.kv_occupancy() == 0
    assert port.kv_free_blocks() is None
