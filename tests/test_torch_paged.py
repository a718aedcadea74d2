"""The paged serving path of the port against the reference, engine by
engine on the same weights: the real-engine cases of test_paged_kv.py and
test_radix_cache.py run on both packages, which must emit identical
greedy tokens and keep identical block accounting (free blocks,
refcounts). Plus the out-of-table write boundary of a run-to-completion
paged decode, and the invariant that no real query row reads the shared
pad block. (Chunked prefill and speculative decoding:
tests/test_torch_chunked_spec.py.)"""
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
from repro_torch.models.transformer import apply_model as tapply  # noqa: E402
from repro_torch.serving import kv_cache as tkvc  # noqa: E402

LITE, CORE = "tiny-lite-llm", "tiny-core-llm"
SHARED = " ".join(f"ctx{i}" for i in range(40))     # 40-token shared prefix
PROMPTS = [("a", "alpha beta gamma delta"),
           ("b", "one two three four five six"),
           ("c", "the quick brown fox jumps")]


@functools.lru_cache(maxsize=None)
def _weights(arch, seed):
    """The reference engine's weights (LLMEngine draws init_params with
    jax.random.key(seed)), as numpy leaves."""
    params = rinit(get_config(arch), jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def _engine(which, arch=LITE, seed=0, **kw):
    """A reference ("ref") or port ("port", CPU) engine holding the same
    weights."""
    kw.setdefault("max_len", 128)
    if which == "ref":
        eng = LLMEngine("t", get_config(arch), seed=seed, **kw)
    else:
        eng = TLLMEngine("t", tget_config(arch), device="cpu", **kw)
        eng.params = bridge.decoder_params(_weights(arch, seed), eng.cfg,
                                           "cpu")
    return eng


def _both(scenario, **kw):
    """Run ``scenario(make)`` on the reference and on the port, where
    ``make(**more)`` builds that package's engine; results must agree."""
    got = {w: scenario(functools.partial(_engine, w, **kw))
           for w in ("ref", "port")}
    assert got["port"] == got["ref"]
    return got["port"]


def _accounting(eng):
    return {"free": eng.alloc.free_blocks(),
            "refs": eng.alloc.refs_snapshot(),
            "tables": {s: list(st.table) for s, st in eng.states.items()},
            "audit": eng.alloc.audit()["ok"]}


def _stopped(eng, out):
    eng.stop_decode_loop()
    return out


# ---------------------------------------------------------------------------
# paged KV (tests/test_paged_kv.py)

@pytest.mark.parametrize("arch", [CORE, LITE])
def test_paged_matches_dense_prefill_decode(arch):
    """Paged pool (windowed layers paged linearly) == dense path, on both
    packages, including a partial prefill extension mid-conversation."""
    def run(make, paged=True):
        eng = make(paged=paged, block_size=8)
        eng.op_prefill([{"sid": "x", "text": "alpha beta gamma"},
                        {"sid": "y", "text": "delta epsilon zeta eta"}])
        out = [eng.op_decode([{"sid": "x", "max_new": 6},
                              {"sid": "y", "max_new": 3}])]
        eng.op_prefill([{"sid": "x", "text": "more words appended now"}])
        out.append(eng.op_decode([{"sid": "x", "max_new": 5}]))
        return {"out": out, "acct": _accounting(eng) if paged else None}

    got = _both(run, arch=arch)
    dense = run(functools.partial(_engine, "port", arch=arch), paged=False)
    assert dense["out"] == got["out"]


def test_paged_matches_dense_continuous_batching():
    def run(make, paged=True):
        eng = make(paged=paged, block_size=8)
        eng.op_prefill([{"sid": "a", "text": "one two three"},
                        {"sid": "b", "text": "four five six seven eight"},
                        {"sid": "c", "text": "nine ten"}])
        seqs = [eng.submit_decode("a", 5), eng.submit_decode("b", 9),
                eng.submit_decode("c", 3)]
        return _stopped(eng, tuple(s.wait(120) for s in seqs))

    got = _both(run)
    assert run(functools.partial(_engine, "port"), paged=False) == got


def test_bucketed_prefill_last_token_exact():
    """Right-padded bucketed paged prefill yields the unpadded forward's
    next token."""
    def run(make):
        eng = make(arch=CORE, paged=True, block_size=8)
        eng.op_prefill([{"sid": "s", "text": "alpha beta gamma"}])
        return eng.states["s"].last_token, eng

    (want, _), (got, port) = run(functools.partial(_engine, "ref")), \
        run(functools.partial(_engine, "port"))
    assert got == want
    toks = port.tok.encode("alpha beta gamma")
    with torch.inference_mode():
        full, _ = tapply(port.cfg, port.params, torch.tensor([toks]))
    assert got == int(torch.argmax(full[0, len(toks) - 1]))


def test_prefix_fork_shares_blocks_and_matches_dense():
    """COW fork of an instruction prefix: full blocks shared (refcount 3),
    the tail block copied per branch, tokens equal to the dense path."""
    instr = " ".join(f"w{i}" for i in range(30))     # 30 tokens, bs=8

    def run(make, paged=True):
        eng = make(arch=CORE, paged=paged, block_size=8)
        pre = eng.get_prefix_state(instr)
        used0 = eng.alloc.used_blocks() if paged else None
        eng.op_prefill([{"sid": "q1", "text": "question one here",
                         "prefix_state": pre}])
        eng.op_prefill([{"sid": "q2", "text": "question two other words",
                         "prefix_state": pre}])
        res = {"out": [eng.op_decode([{"sid": s, "max_new": 4}])
                       for s in ("q1", "q2")]}
        if paged:
            assert used0 == len(pre.table) == 4
            res["shared"] = [eng.alloc.refcount(b) for b in pre.table[:3]]
            res["acct"] = _accounting(eng)
        return res

    got = _both(run)
    assert got["shared"] == [3, 3, 3]
    assert run(functools.partial(_engine, "port"), paged=False)["out"] == \
        got["out"]


def test_bucket_padding_costs_no_blocks():
    def run(make):
        eng = make(paged=True, block_size=4)
        eng.op_prefill([{"sid": "s", "text": "alpha beta gamma"}])
        used = eng.alloc.used_blocks()
        return used, eng.op_decode([{"sid": "s", "max_new": 6}])

    used, _ = _both(run)
    assert used == 1                   # ceil(3/4), not the S=8 bucket's 2


def test_op_prefill_forks_cached_instruction_prefix():
    instr = " ".join(f"w{i}" for i in range(24))

    def run(make):
        warm = make(arch=CORE, paged=True, block_size=8)
        warm.use_prefix_cache = True
        warm.get_prefix_state(instr)
        before = warm.stats["prefill_tokens"]
        warm.op_prefill([{"sid": "q", "text": instr + " tail question"}])
        pre = warm.prefix_cache[instr]
        res = (warm.stats["prefill_tokens"] - before, warm.states["q"].pos,
               [warm.alloc.refcount(b) for b in pre.table[:3]],
               warm.op_decode([{"sid": "q", "max_new": 5}]))
        cold = make(arch=CORE, paged=True, block_size=8)
        cold.op_prefill([{"sid": "q", "text": instr + " tail question"}])
        assert cold.op_decode([{"sid": "q", "max_new": 5}]) == res[3]
        return res

    assert _both(run)[:3] == (2, 26, [2, 2, 2])


def test_decode_batch_overshoot_blocks_trimmed():
    def run(make):
        eng = make(paged=True, block_size=8)
        eng.op_prefill([{"sid": "a", "text": "one two three"},
                        {"sid": "b", "text": "four five six"}])
        out = eng.op_decode([{"sid": "a", "max_new": 24},
                             {"sid": "b", "max_new": 2}])
        return out, eng.states["b"].pos, len(eng.states["b"].table)

    assert _both(run)[1:] == (5, 1)


def test_release_frees_blocks_and_occupancy_counts_blocks():
    def run(make):
        eng = make(paged=True, block_size=8)
        eng.op_prefill([{"sid": "s", "text": "six words of prompt text here"}])
        used = eng.alloc.used_blocks()
        assert eng.kv_occupancy() == used * 8
        assert eng.meter.bytes() == used * eng.meter.block_bytes
        out = eng.op_decode([{"sid": "s", "max_new": 8}])
        used2 = eng.alloc.used_blocks()
        eng.release("s")
        return used, used2, out, _accounting(eng)

    used, used2, _, acct = _both(run)
    assert 0 < used <= used2 and acct["free"] == acct["refs"].count(0) - 1


def test_decode_clamped_to_max_len():
    def run(make):
        eng = make(max_len=32, paged=True, block_size=8)
        eng.op_prefill([{"sid": "s", "text": "one two three four"}])
        out = eng.op_decode([{"sid": "s", "max_new": 100}])[0]
        with pytest.raises(ValueError, match="no KV capacity"):
            eng.op_decode([{"sid": "s", "max_new": 1}])
        return eng.states["s"].pos, len(out.split()), out

    assert _both(run)[:2] == (32, 28)


def test_op_prefill_prompt_equal_to_instruction_matches_cold():
    instr = " ".join(f"w{i}" for i in range(12))

    def run(make):
        warm = make(arch=CORE, paged=True, block_size=8)
        warm.use_prefix_cache = True
        warm.get_prefix_state(instr)
        warm.op_prefill([{"sid": "q", "text": instr}])
        cold = make(arch=CORE, paged=True, block_size=8)
        cold.op_prefill([{"sid": "q", "text": instr}])
        out = warm.op_decode([{"sid": "q", "max_new": 5}])
        assert out == cold.op_decode([{"sid": "q", "max_new": 5}])
        return warm.states["q"].pos, out

    assert _both(run)[0] == 17


def test_table_batch_refuses_writes_past_max_len():
    """A write needing more blocks than max_len allows fails loudly (no
    truncated table), with the reference's error."""
    def run(make):
        eng = make(paged=True, block_size=8, max_len=32)
        st = eng.new_state()
        st.pos = 30
        with pytest.raises(ValueError, match="tables cap at 4") as e:
            eng._table_batch([st], 1, 8)
        return str(e.value)

    _both(run)


def test_decode_admission_backpressure_and_timeout():
    """Port only (timing-driven): a decode that does not fit waits,
    unadmitted, until blocks free up; an unsatisfiable one fails after
    admit_timeout while the queue behind it flows; a request that can
    never fit the pool is refused up front."""
    eng = _engine("port", paged=True, block_size=8, num_blocks=8)
    eng.op_prefill([{"sid": "a", "text": "one two three"}])
    assert eng.submit_decode("a", 24).wait(120)
    eng.op_prefill([{"sid": "b", "text": "four five six"}])
    sb = eng.submit_decode("b", 24)
    time.sleep(0.3)
    assert not sb.done.is_set() and eng._decode_loop.occupancy() == 1
    eng.release("a")
    assert sb.wait(120)
    eng.stop_decode_loop()

    eng = _engine("port", paged=True, block_size=8, num_blocks=6)
    eng.op_prefill([{"sid": "a", "text": " ".join(["w"] * 24)}])
    eng.start_decode_loop().admit_timeout = 0.3
    eng.op_prefill([{"sid": "b", "text": "hi"}])
    with pytest.raises(TimeoutError, match="not admitted"):
        eng.submit_decode("b", 32).wait(30)
    eng.op_prefill([{"sid": "c", "text": "ok"}])
    assert eng.submit_decode("c", 2).wait(60)
    eng.stop_decode_loop()

    eng = _engine("port", paged=True, block_size=8, num_blocks=4)
    eng.op_prefill([{"sid": "a", "text": "hi"}])
    with pytest.raises(ValueError, match="never fit"):
        eng.submit_decode("a", 100)


def test_prefill_backpressure_raises_after_timeout():
    eng = _engine("port", paged=True, block_size=8, num_blocks=6)
    eng.ALLOC_TIMEOUT = 0.2
    eng.op_prefill([{"sid": "a", "text": " ".join(["w"] * 30)}])
    with pytest.raises(tkvc.OutOfBlocks):
        eng.op_prefill([{"sid": "b", "text": " ".join(["v"] * 30)}])
    eng.release("a")
    eng.op_prefill([{"sid": "b", "text": " ".join(["v"] * 30)}])


def test_out_of_table_decode_write_is_dropped():
    """Run-to-completion paged decode, bs=16: row a at pos 16 decodes 16,
    row b at pos 17 decodes 15. b freezes at 32 = 2*16 for the last step,
    whose write falls past its 2-block table: the reference drops it, and
    so must the port (a clamp would overwrite b's live slot 16). A second
    decode then reads that slot."""
    def run(make):
        eng = make(paged=True, block_size=16)
        eng.op_prefill([{"sid": "a", "text": " ".join(
                            f"a{i}" for i in range(16))},
                        {"sid": "b", "text": " ".join(
                            f"b{i}" for i in range(17))}])
        out = [eng.op_decode([{"sid": "a", "max_new": 16},
                              {"sid": "b", "max_new": 15}])]
        assert [eng.states[s].pos for s in "ab"] == [32, 32]
        out.append(eng.op_decode([{"sid": "a", "max_new": 4},
                                  {"sid": "b", "max_new": 4}]))
        return out, _accounting(eng)

    out, _ = _both(run)
    dense = _engine("port", max_len=128)
    dense.op_prefill([{"sid": "b", "text": " ".join(
        f"b{i}" for i in range(17))}])
    assert dense.op_decode([{"sid": "b", "max_new": 15}]) == [out[0][1]]
    assert dense.op_decode([{"sid": "b", "max_new": 4}]) == [out[1][1]]


def test_no_real_row_reads_the_pad_block():
    """Padding rows of every bucketed batch write the shared pad block;
    poisoning it with huge values before each call must not change any
    real row's tokens (their keys stop at their own positions)."""
    def run(poison):
        eng = _engine("port", arch=CORE, paged=True, block_size=8)
        if poison:
            fill = eng._paged_step

            def poisoned(*a, **kw):
                for elems in eng.pool["stages"]:
                    for elem in elems:
                        for arr in elem.values():
                            arr[:, tkvc.PAD_BLOCK] = 3e4
                return fill(*a, **kw)
            eng._paged_step = poisoned
        eng.op_prefill([{"sid": s, "text": t} for s, t in PROMPTS])
        for _, st in eng.states.items():
            assert tkvc.PAD_BLOCK not in st.table
        return eng.op_decode([{"sid": s, "max_new": n}
                              for (s, _), n in zip(PROMPTS, (9, 3, 6))])

    assert run(True) == run(False)


# ---------------------------------------------------------------------------
# radix prefix cache (tests/test_radix_cache.py, engine level)

def _radix(make, radix=True, **kw):
    kw.setdefault("max_len", 256)
    kw.setdefault("max_batch", 4)
    kw.setdefault("block_size", 8)
    return make(paged=True, prefix_cache="radix" if radix else "none", **kw)


def _run_prompts(eng, prompts, max_new=6):
    outs = []
    for i, p in enumerate(prompts):
        eng.op_prefill([{"sid": f"s{i}", "text": p}])
        outs.append(eng.op_decode([{"sid": f"s{i}",
                                    "max_new": max_new}])[0])
    return outs


def test_radix_token_identity_and_prefill_savings():
    prompts = [SHARED + " query one", SHARED + " query two about more",
               "unrelated cold prompt", SHARED + " query one"]

    def run(make):
        on, off = _radix(make), _radix(make, radix=False)
        out = _run_prompts(on, prompts)
        assert out == _run_prompts(off, prompts)
        return (out, on.radix.stats, on.stats["prefill_tokens"],
                off.stats["prefill_tokens"], _accounting(on))

    _, stats, pf_on, pf_off, _ = _both(run)
    assert stats["hit_tokens"] > 0 and pf_on < pf_off


def test_radix_release_keeps_cache_and_reuses_blocks():
    def run(make):
        eng = _radix(make)
        eng.op_prefill([{"sid": "a", "text": SHARED + " tail"}])
        ta = set(eng.states["a"].table)
        eng.release("a")
        used0 = eng.alloc.used_blocks()
        eng.op_prefill([{"sid": "b", "text": SHARED + " tail"}])
        reused = len(set(eng.states["b"].table) & ta)
        grew = eng.alloc.used_blocks() - used0
        eng.release("b")
        return eng.radix.num_blocks(), reused, grew, _accounting(eng)

    cached, reused, grew, _ = _both(run)
    assert cached > 0 and reused > 0 and grew <= 2


def test_radix_chunked_prefill_skips_cached_chunks():
    def run(make):
        res = {}
        for radix in (True, False):
            eng = _radix(make, radix=radix, chunked_prefill=True,
                         prefill_chunk=16)
            out = _run_prompts(eng, [SHARED + " alpha", SHARED + " beta"])
            res[radix] = _stopped(eng, (out, eng.stats["prefill_tokens"]))
        return res

    res = _both(run)
    assert res[True][0] == res[False][0] and res[True][1] < res[False][1]


def test_radix_eviction_under_pressure_stays_token_identical():
    prompts = [" ".join(f"p{k}w{i}" for i in range(30)) + " q"
               for k in range(6)]

    def run(make):
        on, off = _radix(make, num_blocks=16), \
            _radix(make, radix=False, num_blocks=16)
        outs = []
        for i, p in enumerate(prompts):
            for eng in (on, off):
                eng.op_prefill([{"sid": f"s{i}", "text": p}])
            outs.append(on.op_decode([{"sid": f"s{i}", "max_new": 4}]))
            assert outs[-1] == off.op_decode([{"sid": f"s{i}",
                                               "max_new": 4}])
            on.release(f"s{i}")
            off.release(f"s{i}")
        evictions = on.radix.stats["evictions"]
        on.radix.evict(10**6)
        return outs, evictions, on.alloc.free_blocks() == on.alloc.capacity

    _, evictions, clean = _both(run)
    assert evictions > 0 and clean


def test_radix_admission_counts_cached_blocks_as_evictable():
    def run(make):
        eng = _radix(make, num_blocks=12, max_len=64)
        eng.op_prefill([{"sid": "warm", "text": " ".join(
            f"w{i}" for i in range(50))}])
        eng.release("warm")
        free = eng.kv_free_blocks()
        eng.op_prefill([{"sid": "d", "text": "short seed prompt"}])
        out = _stopped(eng, eng.submit_decode("d", 48).wait(60))
        return free, out, eng.radix.stats["freed_blocks"] > 0

    free, _, freed = _both(run)
    assert free == 11 and freed


def test_radix_cold_vs_warm_replica_symmetry():
    instr = " ".join(f"inst{i}" for i in range(16))  # 2 full blocks
    queries = [instr + " ask one", instr + " ask two"]

    def sharing(eng):
        tables = [eng.states[f"s{i}"].table for i in range(len(queries))]
        return sorted(len(set(a) & set(b)) for i, a in enumerate(tables)
                      for b in tables[i + 1:])

    def run(make):
        warm = _radix(make)
        warm.get_prefix_state(instr)
        warm_out = _run_prompts(warm, queries)
        cold = _radix(make)
        assert _run_prompts(cold, queries) == warm_out
        assert sharing(warm) == sharing(cold)
        return warm_out, sharing(cold)

    assert _both(run)[1][0] >= 2


def test_radix_flag_off_and_validation():
    eng = _radix(functools.partial(_engine, "port"), radix=False)
    assert eng.radix is None
    assert eng.prefix_match_len("anything at all") == 0
    assert eng.kv_free_blocks() == eng.alloc.free_blocks()
    with pytest.raises(ValueError, match="requires paged"):
        _engine("port", paged=False, prefix_cache="radix")
    with pytest.raises(ValueError, match="prefix_cache"):
        _engine("port", paged=True, prefix_cache="bogus")
