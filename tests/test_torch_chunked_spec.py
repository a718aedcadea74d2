"""Chunked prefill and speculative decoding in the port against the
reference, engine by engine on the same weights: the real-engine cases of
test_chunked_prefill.py and test_spec_decode.py, dense and paged, run on
both packages (or, for the timing-driven loop cases, checked against the
reference's tokens), which must emit identical greedy tokens."""
import functools
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.engines.llm_engine import LLMEngine  # noqa: E402
from repro.models.transformer import init_params as rinit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.engines.llm_engine import LLMEngine as TLLMEngine  # noqa: E402
from repro_torch.serving import kv_cache as tkvc  # noqa: E402

LITE, CORE = "tiny-lite-llm", "tiny-core-llm"
LONG = " ".join(f"tok{i}" for i in range(90))
PROMPTS = [("a", "alpha beta gamma delta"),
           ("b", "one two three four five six"),
           ("c", "the quick brown fox jumps")]


@functools.lru_cache(maxsize=None)
def _weights(arch, seed):
    """The reference engine's weights (LLMEngine draws init_params with
    jax.random.key(seed)), as numpy leaves."""
    params = rinit(get_config(arch), jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def _engine(which, arch=LITE, seed=0, spec=None, **kw):
    """A reference ("ref") or port ("port", CPU) engine holding the same
    weights; ``spec`` = (draft_engine_or_None, k) enables speculation."""
    kw.setdefault("max_len", 128)
    if which == "ref":
        eng = LLMEngine("t", get_config(arch), seed=seed, **kw)
    else:
        eng = TLLMEngine("t", tget_config(arch), device="cpu", **kw)
        eng.params = bridge.decoder_params(_weights(arch, seed), eng.cfg,
                                           "cpu")
    if spec is not None:
        draft, k = spec
        eng.enable_speculative(draft=draft(which) if draft else None, k=k)
    return eng


def _both(scenario, **kw):
    """Run ``scenario(make)`` on the reference and on the port, where
    ``make(**more)`` builds that package's engine; results must agree."""
    got = {w: scenario(functools.partial(_engine, w, **kw))
           for w in ("ref", "port")}
    assert got["port"] == got["ref"]
    return got["port"]


def _wait(pred, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.002)
    return False


def _stopped(eng, out):
    eng.stop_decode_loop()
    return out


# ---------------------------------------------------------------------------
# chunked prefill (tests/test_chunked_prefill.py)

@pytest.mark.parametrize("paged", [False, True])
def test_prefill_chunked_matches_monolithic(paged):
    def run(make):
        a, b = make(paged=paged, max_len=256), make(paged=paged, max_len=256)
        sa, toks, _ = a._prepare_prefill_task({"sid": "x", "text": LONG})
        a.prefill_batch([(sa, toks)])
        sb, toks_b, _ = b._prepare_prefill_task({"sid": "x", "text": LONG})
        b.prefill_chunked([(sb, toks_b)], chunk=32)
        assert (sa.pos, sa.last_token) == (sb.pos, sb.last_token)
        out = a.op_decode([{"sid": "x", "max_new": 8}])
        assert out == b.op_decode([{"sid": "x", "max_new": 8}])
        return sb.pos, out

    _both(run)


@pytest.mark.parametrize("paged", [False, True])
def test_loop_chunked_prefill_token_identity(paged):
    def run(make):
        outs = []
        for chunked in (True, False):
            eng = make(paged=paged, chunked_prefill=chunked,
                       prefill_chunk=32, max_len=256)
            eng.op_prefill([{"sid": "a", "text": LONG}])
            outs.append(_stopped(eng, eng.op_decode(
                [{"sid": "a", "max_new": 8}])))
        assert outs[0] == outs[1]
        return outs[0]

    _both(run)


@pytest.mark.parametrize("paged", [False, True])
def test_mixed_iterations_token_identity_with_resident_decodes(paged):
    """A long prompt chunking BETWEEN resident decodes' iterations: every
    stream equals the sequential monolithic run (port), which equals the
    reference's."""
    def run(make, chunked):
        eng = make(paged=paged, chunked_prefill=chunked, prefill_chunk=16,
                   token_budget=24, max_len=256, max_batch=4)
        eng.tok.encode(LONG)
        eng.op_prefill([{"sid": "d1", "text": "short prompt one"},
                        {"sid": "d2", "text": "another short prompt"}])
        s1, s2 = eng.submit_decode("d1", 20), eng.submit_decode("d2", 20)
        assert _wait(lambda: s1.steps >= 2)
        if chunked:
            job = eng.submit_prefill({"sid": "long", "text": LONG})
            job.wait(120)
            assert job.chunks > 1
            outs = [s1.wait(120), s2.wait(120)]
        else:
            outs = [s1.wait(120), s2.wait(120)]
            eng.op_prefill([{"sid": "long", "text": LONG}])
        outs.append(eng.op_decode([{"sid": "long", "max_new": 8}])[0])
        return _stopped(eng, outs)

    port = functools.partial(_engine, "port")
    got = run(port, True)
    assert got == run(port, False) == \
        run(functools.partial(_engine, "ref"), False)


def test_mid_prefill_decode_admission_and_eviction():
    eng = _engine("port", paged=True, chunked_prefill=True, prefill_chunk=8,
                  token_budget=12, max_len=384, max_batch=4)
    eng.op_prefill([{"sid": "d1", "text": "short prompt one"}])
    s1 = eng.submit_decode("d1", 6)
    job = eng.submit_prefill({"sid": "long", "text": LONG})
    assert _wait(lambda: job.chunks >= 1)
    eng.op_prefill([{"sid": "d2", "text": "another short prompt"}])
    s2 = eng.submit_decode("d2", 6)
    job.wait(120)
    s1.wait(120)
    s2.wait(120)
    loop = eng._decode_loop
    first_chunk = min(i for _, i, _ in loop.prefill_chunks)
    last_chunk = max(i for _, i, _ in loop.prefill_chunks)
    evict_d1 = next(i for sid, i, _ in loop.evictions if sid == "d1")
    admit_d2 = next(i for sid, i in loop.admissions if sid == "d2")
    assert first_chunk < evict_d1 <= last_chunk + 1
    assert first_chunk < admit_d2 <= last_chunk
    eng.stop_decode_loop()


def test_chunked_prefill_with_prefix_fork_identity():
    instr = "system instruction used for every query"
    suffix = " ".join(f"q{i}" for i in range(70))

    def run(make):
        res = []
        for chunked in (True, False):
            eng = make(paged=True, chunked_prefill=chunked,
                       prefill_chunk=16, max_len=256)
            eng.get_prefix_state(instr)
            eng.use_prefix_cache = True
            eng.op_prefill([{"sid": "a", "text": f"{instr} {suffix}"}])
            out = eng.op_decode([{"sid": "a", "max_new": 8}])[0]
            res.append(_stopped(eng, (out, eng.stats["prefill_tokens"])))
        assert res[0] == res[1]
        return res[0]

    _both(run)


def test_chunked_prefill_with_speculative_decode():
    def run(make, spec):
        eng = make(paged=True, chunked_prefill=True, prefill_chunk=16,
                   token_budget=48, max_len=384, max_batch=4,
                   spec=(None, 3) if spec else None)
        eng.op_prefill([{"sid": "d", "text": "repeat repeat repeat"}])
        s = eng.submit_decode("d", 24)
        assert _wait(lambda: s.steps >= 1)
        job = eng.submit_prefill({"sid": "long", "text": LONG})
        job.wait(120)
        return _stopped(eng, [s.wait(120), eng.op_decode(
            [{"sid": "long", "max_new": 8}])[0]])

    port = functools.partial(_engine, "port")
    assert run(port, True) == run(port, False) == \
        run(functools.partial(_engine, "ref"), True)


def test_chunked_capacity_refusal_and_declined_chunk_retried():
    eng = _engine("port", max_len=256, max_batch=2, paged=True,
                  block_size=16, num_blocks=4, chunked_prefill=True,
                  prefill_chunk=16)
    with pytest.raises(ValueError, match="never fit"):
        eng.submit_prefill({"sid": "big", "text": LONG})
    eng = _engine("port", max_len=256, max_batch=2, paged=True,
                  block_size=16, num_blocks=12, chunked_prefill=True,
                  prefill_chunk=32)
    eng.op_prefill([{"sid": "d", "text": "short prompt"}])
    s = eng.submit_decode("d", 40)          # reserves most of the pool
    assert _wait(lambda: s.steps >= 1)
    job = eng.submit_prefill({"sid": "p", "text": " ".join(
        f"x{i}" for i in range(60))})
    job.wait(120)
    s.wait(120)
    assert job.cursor == len(job.tokens)
    eng.stop_decode_loop()


# ---------------------------------------------------------------------------
# speculative decoding (tests/test_spec_decode.py)

def _draft(which):
    """Same-weights draft engine: the acceptance ceiling."""
    return _engine(which, arch=CORE)


def _prefill(eng, prompts=PROMPTS):
    eng.op_prefill([{"sid": s, "text": t} for s, t in prompts])


@pytest.mark.parametrize("paged", [False, True])
def test_spec_matches_baseline_legacy(paged):
    reqs = [{"sid": "a", "max_new": 20}, {"sid": "b", "max_new": 7},
            {"sid": "c", "max_new": 13}]

    def run(make):
        eng = make(arch=CORE, paged=paged, block_size=8, spec=(None, 3))
        _prefill(eng)
        return eng.op_decode([dict(r) for r in reqs]), eng.spec.stats

    out, stats = _both(run)
    base = _engine("port", arch=CORE)
    _prefill(base)
    assert out == base.op_decode([dict(r) for r in reqs])
    assert stats["tokens_emitted"] == 40


@pytest.mark.parametrize("paged", [False, True])
def test_spec_matches_baseline_draft_engine(paged):
    def run(make):
        eng = make(arch=CORE, paged=paged, block_size=8, spec=(_draft, 3))
        _prefill(eng)
        return eng.op_decode([{"sid": "a", "max_new": 24}]), eng.spec.stats

    out, stats = _both(run)
    base = _engine("port", arch=CORE)
    _prefill(base)
    assert out == base.op_decode([{"sid": "a", "max_new": 24}])
    assert stats["seq_steps"] <= -(-24 // 4) + 1 and stats["accepted"] >= 18


@pytest.mark.parametrize("paged", [False, True])
def test_spec_matches_baseline_continuous(paged):
    def run(make, spec):
        eng = make(arch=CORE, paged=paged, block_size=8, max_batch=2,
                   spec=(None, 3) if spec else None)
        _prefill(eng)
        seqs = [eng.submit_decode("a", 5), eng.submit_decode("b", 17),
                eng.submit_decode("c", 11)]
        return _stopped(eng, tuple(s.wait(120) for s in seqs))

    port = functools.partial(_engine, "port")
    assert run(port, True) == run(port, False) == \
        run(functools.partial(_engine, "ref"), True)


def test_spec_continuous_draft_engine_paged():
    def run(make):
        eng = make(arch=CORE, paged=True, block_size=8, max_batch=4,
                   spec=(_draft, 3))
        _prefill(eng)
        seqs = [eng.submit_decode(s, 16) for s, _ in PROMPTS]
        out = tuple(s.wait(120) for s in seqs)
        assert eng._decode_loop.iterations < 16
        return _stopped(eng, out)

    out = _both(run)
    base = _engine("port", arch=CORE)
    _prefill(base)
    assert list(out) == base.op_decode([{"sid": s, "max_new": 16}
                                        for s, _ in PROMPTS])


def test_spec_rollback_frees_overshoot_blocks():
    def run(make):
        eng = make(arch=CORE, paged=True, block_size=8, spec=(None, 4))
        _prefill(eng, PROMPTS[:1])
        out = eng.op_decode([{"sid": "a", "max_new": 10}])
        st = eng.states["a"]
        assert len(st.table) == tkvc.blocks_for(st.pos, 8)
        eng.release("a")
        return out, eng.alloc.used_blocks()

    assert _both(run)[1] == 0


def test_spec_prefix_fork_identity():
    instr = " ".join(f"w{i}" for i in range(24))

    def run(make, spec):
        eng = make(arch=CORE, paged=True, block_size=8,
                   spec=(None, 3) if spec else None)
        eng.use_prefix_cache = True
        eng.get_prefix_state(instr)
        eng.op_prefill([{"sid": "q", "text": instr + " tail question"}])
        return eng.op_decode([{"sid": "q", "max_new": 12}])

    port = functools.partial(_engine, "port")
    assert run(port, True) == run(port, False) == \
        run(functools.partial(_engine, "ref"), True)
