"""The cross-feature equivalence matrix of tests/test_cache_equivalence.py
over the port's engines: every combination of {radix prefix cache on/off}
x {dense/paged} x {legacy/continuous decode} x {chunked prefill on/off} x
{speculative on/off} must emit the exact tokens of the canonical all-off
engine, which itself must equal the reference's all-off engine on the
same weights; plus the mid-stream admission/eviction cell under pool
pressure, with no block leaked."""
import functools
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.engines.llm_engine import LLMEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.engines.llm_engine import LLMEngine as TLLMEngine  # noqa: E402

ARCH = "tiny-lite-llm"
SHARED = " ".join(f"ctx{i}" for i in range(24))
PROMPTS = [
    ("q0", SHARED + " alpha beta"),
    ("q1", SHARED + " gamma delta"),      # shared 24-word prefix
    ("q2", SHARED + " epsilon zeta"),
    ("q3", "a totally different prompt about optics"),
]
# (radix, paged, continuous, chunked, spec); radix requires the paged
# block pool -> those 8 cells are structurally invalid, leaving 24.
MATRIX = [c for c in itertools.product([False, True], repeat=5)
          if not (c[0] and not c[1])]


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's all-off engine (its weights and its tokens)."""
    ref = LLMEngine("m", get_config(ARCH), max_len=256, seed=0,
                    max_batch=4)
    for sid, text in PROMPTS:
        ref.op_prefill([{"sid": sid, "text": text}])
    res = ref.op_decode([{"sid": sid, "max_new": 10} for sid, _ in PROMPTS])
    weights = jax.tree.map(np.asarray, ref.params)
    return weights, {sid: r for (sid, _), r in zip(PROMPTS, res)}


def _engine(**kw):
    eng = TLLMEngine("m", tget_config(ARCH), max_len=256, device="cpu",
                     **kw)
    eng.params = bridge.decoder_params(_reference()[0], eng.cfg, "cpu")
    return eng


def _run_cell(*, radix, paged, continuous, chunked, spec):
    eng = _engine(max_batch=4, paged=paged, block_size=8,
                  chunked_prefill=chunked, prefill_chunk=24,
                  prefix_cache="radix" if radix else "none")
    if spec:
        eng.enable_speculative(draft=None, k=3)
    # prefill sequentially so later prompts can hit prefixes cached by
    # earlier ones (same-batch tasks insert only after the batch)
    for sid, text in PROMPTS:
        eng.op_prefill([{"sid": sid, "text": text}])
    if continuous:
        seqs = [(sid, eng.submit_decode(sid, 10)) for sid, _ in PROMPTS]
        outs = {sid: sq.wait(120) for sid, sq in seqs}
    else:
        res = eng.op_decode([{"sid": sid, "max_new": 10}
                             for sid, _ in PROMPTS])
        outs = {sid: r for (sid, _), r in zip(PROMPTS, res)}
    stats = dict(eng.radix.stats) if eng.radix is not None else None
    eng.stop_decode_loop()
    return outs, stats


@functools.lru_cache(maxsize=None)
def _baseline():
    outs, _ = _run_cell(radix=False, paged=False, continuous=False,
                        chunked=False, spec=False)
    return outs


def test_all_off_baseline_matches_reference():
    assert _baseline() == _reference()[1]


@pytest.mark.parametrize("radix,paged,continuous,chunked,spec", MATRIX)
def test_feature_matrix_token_identity(radix, paged, continuous, chunked,
                                       spec):
    outs, stats = _run_cell(radix=radix, paged=paged, continuous=continuous,
                            chunked=chunked, spec=spec)
    assert outs == _baseline()
    if radix:
        # the shared 24-word prefix (3 full blocks) must actually hit
        assert stats["hits"] >= 2 and stats["hit_tokens"] >= 2 * 24


def test_matrix_mid_stream_admission_and_eviction():
    """radix + paged + continuous + chunked with a pool small enough that
    later admissions must evict cached leaves while a long decode stays
    resident: tokens equal the all-off engine run sequentially, and
    nothing leaks."""
    shared16 = " ".join(SHARED.split()[:16])
    prompts = [("p%d" % i, shared16 + " " +
                " ".join(f"t{i}w{j}" for j in range(8)))
               for i in range(8)]
    base = _engine(max_batch=8)
    expect = {}
    for sid, text in prompts + [("bg", "background long decode prompt")]:
        base.op_prefill([{"sid": sid, "text": text}])
    for sid, _ in prompts:
        expect[sid] = base.op_decode([{"sid": sid, "max_new": 8}])[0]
    expect["bg"] = base.op_decode([{"sid": "bg", "max_new": 40}])[0]

    eng = _engine(max_batch=8, paged=True, block_size=8, num_blocks=14,
                  chunked_prefill=True, prefill_chunk=16,
                  prefix_cache="radix")
    eng.op_prefill([{"sid": "bg", "text": "background long decode prompt"}])
    bg = eng.submit_decode("bg", 40)    # stays resident throughout
    outs = {}
    for sid, text in prompts:           # admitted mid-decode, one by one
        eng.op_prefill([{"sid": sid, "text": text}])
        outs[sid] = eng.submit_decode(sid, 8).wait(120)
        eng.release(sid)                # only the radix refs survive
    outs["bg"] = bg.wait(120)
    stats = dict(eng.radix.stats)
    eng.stop_decode_loop()

    assert outs == expect
    assert stats["hits"] >= 4 and stats["evictions"] > 0
    for sid in list(eng.states):
        eng.release(sid)
    eng.radix.evict(10 ** 6)
    assert eng.alloc.free_blocks() == eng.alloc.capacity
    assert eng.alloc.audit()["ok"]
