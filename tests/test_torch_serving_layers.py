"""The serving layers on the port's real engines against the reference's,
on the same weights: the real-engine cases of tests/test_slo_sched.py
(preemption and replay), tests/test_faults.py (allocator diagnostics,
dead-replica reclamation, token-identical recovery, a replica killed in a
pool), tests/test_overload.py (degraded prefill chunks) and
tests/test_disagg.py (migrate_blocks and the engine-level handoff). Each
case runs on both packages, holds the reference test's invariants on
each, and the two must emit the same tokens and keep the same block
accounting."""
import functools
import threading
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.core import apps as rapps  # noqa: E402
from repro.core import engine_pool as rpool  # noqa: E402
from repro.core import teola as rteola  # noqa: E402
from repro.engines import decode_loop as rloop  # noqa: E402
from repro.engines.llm_engine import LLMEngine  # noqa: E402
from repro.models.transformer import init_params as rinit  # noqa: E402
from repro.serving import faults as rfaults  # noqa: E402
from repro.serving import kv_cache as rkvc  # noqa: E402
from repro.serving import slo as rslo  # noqa: E402
from repro.training.data import doc_corpus  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config as tget_config  # noqa: E402
from repro_torch.core import apps as tapps  # noqa: E402
from repro_torch.core import engine_pool as tpool  # noqa: E402
from repro_torch.core import teola as tteola  # noqa: E402
from repro_torch.engines import decode_loop as tloop  # noqa: E402
from repro_torch.engines.llm_engine import LLMEngine as TLLMEngine  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import kv_cache as tkvc  # noqa: E402
from repro_torch.serving import slo as tslo  # noqa: E402

LITE = "tiny-lite-llm"
PKGS = ("ref", "port")
Q = {"question": "what is fact 3 about optics", "docs": doc_corpus(2)}
# the reference's real-engine recovery knobs (tests/test_faults.py)
_FT_REAL = dict(max_retries=3, backoff=0.05, suspect_after=20.0,
                dead_after=45.0, watchdog_period=0.2)


@functools.lru_cache(maxsize=None)
def _weights(arch, seed):
    """The reference engine's weights (LLMEngine draws init_params with
    jax.random.key(seed)), as numpy leaves."""
    return jax.tree.map(np.asarray, rinit(get_config(arch),
                                          jax.random.key(seed)))


def _llm(pkg, name, arch=LITE, seed=0, **kw):
    """A reference or port (CPU) LLM engine holding the same weights."""
    if pkg == "ref":
        return LLMEngine(name, get_config(arch), seed=seed, **kw)
    eng = TLLMEngine(name, tget_config(arch), device="cpu", **kw)
    eng.params = bridge.decoder_params(_weights(arch, seed), eng.cfg, "cpu")
    return eng


def _engines(pkg, **kw):
    """The app engine set of one package; the port's holds the
    reference's weights (as tests/test_torch_e2e.py builds it)."""
    ref = rapps.build_engines(**kw)
    if pkg == "ref":
        return ref
    port = tapps.build_engines(device="cpu", **kw)
    for name in ("core_llm", "lite_llm"):
        port[name].params = bridge.decoder_params(
            jax.tree.map(np.asarray, ref[name].params), port[name].cfg,
            "cpu")
    for name in ("embedding", "rerank"):
        port[name].params = bridge.encoder_params(
            jax.tree.map(np.asarray, ref[name].params), port[name].cfg,
            "cpu")
    return port


M = {"ref": types.SimpleNamespace(kvc=rkvc, slo=rslo, faults=rfaults,
                                  loop=rloop, pool=rpool, apps=rapps,
                                  teola=rteola),
     "port": types.SimpleNamespace(kvc=tkvc, slo=tslo, faults=tfaults,
                                   loop=tloop, pool=tpool, apps=tapps,
                                   teola=tteola)}


def _on_both(case):
    """A test that runs ``case(pkg)`` on each package, then holds the
    port's result equal to the reference's."""
    def test():
        got = {pkg: case(pkg) for pkg in PKGS}
        assert got["port"] == got["ref"], got
    test.__doc__ = getattr(case, "__doc__", None)
    return test


# ---------------------------------------------------------------------------
# SLO preemption: evict-to-recompute and token-identical replay

def _drive(eng, seq, iters):
    for _ in range(iters):
        before = len(seq.tokens)
        eng.decode_iteration([seq])
        seq.steps += max(1, len(seq.tokens) - before)


def _preempt_resume(pkg, paged):
    m = M[pkg]
    kw = dict(max_len=128, max_batch=4)
    if paged:
        kw.update(paged=True, block_size=8, num_blocks=64)

    def fresh():
        eng = _llm(pkg, "t", **kw)
        m.slo.attach_slo({"llm": eng}, preempt_cooldown_s=0.0)
        eng.op_prefill([{"sid": "s", "text":
                         "some moderately long prompt words here"}])
        seq = m.loop.DecodeSeq("s", eng.states["s"], 10,
                               text_fn=lambda q: eng.tok.decode(q.tokens))
        assert eng.try_admit(seq)
        eng.note_slot_acquired(seq)
        return eng, seq

    eng0, base = fresh()
    _drive(eng0, base, 10)
    eng, seq = fresh()
    _drive(eng, seq, 4)
    assert eng.can_preempt(seq)
    freed = None
    if paged:
        used_before = eng.num_blocks - eng.alloc.free_blocks()
    eng.preempt_decode(seq)
    if paged:
        freed = used_before - (eng.num_blocks - eng.alloc.free_blocks())
        assert freed > 0
        assert seq.state.pos == 0 and len(seq.state.table) == 0
    assert eng.try_admit(seq)
    eng.note_slot_acquired(seq)
    _drive(eng, seq, 6)          # the replay runs inside the first pass
    assert not seq.slo_preempted
    assert seq.tokens == base.tokens
    eng.note_slot_released(seq)
    eng.release("s")
    if paged:
        rep = eng.alloc.audit()
        assert rep["bad_free"] == 0 and rep["leaked"] == 0
        assert eng.alloc.free_blocks() == eng.alloc.capacity
    return list(seq.tokens), freed


test_preempt_resume_token_identical_dense = _on_both(
    functools.partial(_preempt_resume, paged=False))
test_preempt_resume_token_identical_paged = _on_both(
    functools.partial(_preempt_resume, paged=True))


@pytest.mark.parametrize("pkg", PKGS)
def test_can_preempt_excludes_unrecorded_sequences(pkg):
    m = M[pkg]
    eng = _llm(pkg, "t", max_len=128)
    eng.op_prefill([{"sid": "s", "text": "prompt words"}])    # unarmed
    m.slo.attach_slo({"llm": eng})
    seq = m.loop.DecodeSeq("s", eng.states["s"], 4,
                           text_fn=lambda q: eng.tok.decode(q.tokens))
    assert not eng.can_preempt(seq)


def _slo_loop_pressure(pkg):
    """A batch-class sequence holds the only decode slot; an interactive
    one arrives and the loop preempts the batch sequence, which later
    resumes by replay: both finish with the tokens of an unpreempted
    run."""
    m = M[pkg]
    texts = {"b": "batch tenant prompt words here",
             "i": "interactive tenant prompt"}
    n = {"b": 48, "i": 8}
    solo = _llm(pkg, "solo", max_len=128)
    want = {}
    for sid, text in texts.items():
        solo.op_prefill([{"sid": sid, "text": text}])
        want[sid] = solo.op_decode([{"sid": sid, "max_new": n[sid]}])[0]
    eng = _llm(pkg, "t", max_len=128, max_batch=1, paged=True,
               block_size=8, num_blocks=64)
    m.slo.attach_slo({"llm": eng}, preempt_cooldown_s=0.0)
    for sid, text in texts.items():
        eng.op_prefill([{"sid": sid, "text": text}])
    b = eng.submit_decode("b", n["b"],
                          slo=m.slo.derive_tag(slo="batch", tenant="t1"))
    while (b.t_admit is None or b.steps <= 2) and not b.done.is_set():
        b.done.wait(0.002)
    i = eng.submit_decode("i", n["i"], slo=m.slo.derive_tag(
        slo="interactive", tenant="t0"))
    assert i.wait(120) is not None and b.wait(120) is not None
    loop = eng._decode_loop
    eng.stop_decode_loop()
    assert b.error is None and i.error is None
    assert [p[0] for p in loop.preemptions] == ["b"], loop.preemptions
    assert {"b": b.result, "i": i.result} == want
    for sid in texts:
        eng.release(sid)
    assert eng.alloc.audit()["ok"]
    assert eng.alloc.free_blocks() == eng.alloc.capacity
    return [b.result, i.result]


test_loop_preempts_batch_for_interactive_real_engine = _on_both(
    _slo_loop_pressure)


# ---------------------------------------------------------------------------
# Faults: allocator diagnostics, reclamation, recovery, a killed replica

def _paged(pkg, name="p", **kw):
    kw.setdefault("num_blocks", 32)
    return _llm(pkg, name, max_len=256, paged=True, block_size=8, **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_out_of_blocks_message_carries_allocator_diagnostics(pkg):
    text = " ".join(f"w{i}" for i in range(20))
    probe = _llm(pkg, "pr", max_len=128, paged=True, block_size=8)
    probe.op_prefill([{"sid": "bg", "text": text}])
    nb = len(probe.states["bg"].table)
    eng = _llm(pkg, "d", max_len=128, paged=True, block_size=8,
               num_blocks=nb + 1)
    eng.ALLOC_TIMEOUT = 0.1
    eng.op_prefill([{"sid": "bg", "text": text}])
    with pytest.raises(M[pkg].kvc.OutOfBlocks) as e:
        eng.op_prefill([{"sid": "s2", "text": " ".join(
            f"v{i}" for i in range(20))}])
    for frag in ("diag:", "reserved=", "evictable_radix=", "waiters=",
                 "resident_seqs="):
        assert frag in str(e.value)


def _reclaim(pkg):
    eng = _paged(pkg, prefix_cache="radix")
    text = " ".join(f"w{i}" for i in range(16))
    eng.op_prefill([{"sid": "s0", "text": text + " alpha"},
                    {"sid": "s1", "text": text + " beta"}])
    used = eng.alloc.used_blocks()
    assert used > 0 and eng.radix.num_blocks() > 0
    report = M[pkg].kvc.reclaim_replica(eng)
    assert report["ok"] and not report["written_off"]
    assert report["leaked"] == 0 and report["released"] == 2
    assert report["radix_refs"] > 0
    assert eng.alloc.free_blocks() == eng.alloc.capacity
    assert eng.alloc.audit()["ok"]
    assert eng.states == {} and eng.radix.num_blocks() == 0
    return used, report


test_reclaim_replica_returns_all_blocks_and_audits_clean = _on_both(
    _reclaim)


@pytest.mark.parametrize("pkg", PKGS)
def test_reclaim_replica_writes_off_when_lock_is_hung(pkg):
    eng = _paged(pkg)
    eng.op_prefill([{"sid": "s", "text": "a few words here"}])
    grabbed, done = threading.Event(), threading.Event()

    def wedge():
        with eng._paged_lock:
            grabbed.set()
            done.wait(5)

    t = threading.Thread(target=wedge, daemon=True)
    t.start()
    assert grabbed.wait(5)
    try:
        report = M[pkg].kvc.reclaim_replica(eng, lock_timeout=0.1)
    finally:
        done.set()
        t.join(5)
    assert not t.is_alive()
    assert report["written_off"] and not report["ok"]
    assert "s" in eng.states


def _recover(pkg, text, n, cuts):
    a = _paged(pkg)
    a.op_prefill([{"sid": "s", "text": text}])
    ref = a.submit_decode("s", n)
    assert ref.wait(120)
    a.stop_decode_loop()
    out = [list(ref.tokens)]
    for cut in cuts:
        b = a.clone(1)
        failed = None if cut is None else \
            types.SimpleNamespace(tokens=ref.tokens[:cut])
        sq = b.recover_decode("s", text, n, failed)
        assert sq.wait(120), f"recovery at cut={cut} timed out"
        assert sq.result == ref.result and sq.tokens == ref.tokens
        b.stop_decode_loop()
        out.append(list(sq.tokens))
    return out


test_recover_decode_token_identical_real_engine = _on_both(
    functools.partial(_recover, text="alpha beta gamma delta epsilon zeta",
                      n=8, cuts=(0, 3, 8)))
test_recover_decode_without_failed_handle = _on_both(
    functools.partial(_recover, text="one two three four five", n=6,
                      cuts=(None,)))


def _migration_fault(pkg):
    f = M[pkg].faults
    pe = _paged(pkg)
    de = pe.clone(1)
    pe.op_prefill([{"sid": "s", "text": "some words to migrate over"}])
    nb = pe.alloc.used_blocks()
    de.faults = f.FaultInjector([f.FaultSpec("migrate_fail", "p.r1",
                                             "migrate", at=1)])
    with pytest.raises(f.MigrationFault):
        de.import_seq(pe.export_seq("s"))
    assert "s" in pe.states and pe.alloc.used_blocks() == nb
    assert de.alloc.used_blocks() == 0
    assert de.import_seq(pe.export_seq("s")) is None
    assert de.alloc.used_blocks() == nb and "s" not in pe.states
    return de.op_decode([{"sid": "s", "max_new": 6}])[0]


test_migration_fault_leaves_source_intact_and_is_retryable = _on_both(
    _migration_fault)


def _pool_run(pkg, injector, ft):
    m = M[pkg]
    engines = m.pool.build_pools(_engines(pkg, paged_kv=True),
                                 {"core_llm": 4})
    if injector is not None:
        injector.arm(engines)
    orch = m.teola.Teola(m.apps.naive_rag(engines), engines,
                         continuous_batching=True, fault_tolerance=ft)
    try:
        out, ctx = orch.query(dict(Q), timeout=600)
        assert ctx.error is None
        return out, engines, orch
    finally:
        orch.shutdown()


def _replica_kill(pkg):
    f = M[pkg].faults
    baseline, _, _ = _pool_run(pkg, None, None)
    inj = f.FaultInjector([f.FaultSpec("crash", "core_llm", "decode", at=2)])
    out, engines, orch = _pool_run(pkg, inj, f.FTConfig(**_FT_REAL))
    assert inj.log, "fault never fired"
    assert out == baseline
    pool = engines["core_llm"]
    assert pool.health(0) == "dead"
    mgr = orch.runtime.scheds["core_llm"].ftmgr
    assert any(e[0] == "retry" for e in mgr.events), mgr.events
    for rep in mgr.reclaim_reports:
        assert rep["leaked"] == 0 and rep["ok"], rep
    for i in range(len(pool)):
        if pool.health(i) != "dead":
            assert pool[i].alloc.audit()["ok"]
            assert pool[i].alloc.free_blocks() == pool[i].alloc.capacity
    return out


test_real_engine_replica_kill_is_token_identical = _on_both(_replica_kill)


# ---------------------------------------------------------------------------
# Overload: a degraded prefill chunk cap keeps the tokens

def _chunk_cap(pkg):
    text = " ".join(f"w{i}" for i in range(40))

    def run(cap):
        eng = _llm(pkg, "d", max_len=256, max_batch=4, paged=True,
                   block_size=8, chunked_prefill=True, prefill_chunk=32)
        job = eng.submit_prefill({"sid": "s", "text": text})
        if cap:
            job.chunk_cap = cap
        job.wait(120)
        sq = eng.submit_decode("s", 8)
        assert sq.wait(120)
        toks = list(sq.tokens)
        eng.stop_decode_loop()
        eng.release("s")
        rep = eng.alloc.audit()
        assert rep["leaked"] == 0 and rep["bad_free"] == 0, rep
        assert eng.alloc.free_blocks() == eng.alloc.capacity
        return toks

    capped = run(8)
    assert capped == run(0)
    return capped


test_degraded_chunk_cap_token_identical_and_zero_leaked_blocks = _on_both(
    _chunk_cap)


# ---------------------------------------------------------------------------
# Disaggregation: migrate_blocks, then the engine-level handoff

def _stamped_pool(pkg, num_blocks, block_size=4):
    """A paged pool whose every cell holds its own block id."""
    if pkg == "ref":
        pool = rkvc.init_paged_pool(get_config(LITE), num_blocks, block_size)

        def stamp(a):
            ids = np.arange(a.shape[1], dtype=np.float32).reshape(
                (1, -1) + (1,) * (a.ndim - 2))
            return jax.numpy.asarray(np.broadcast_to(ids, a.shape),
                                     a.dtype)
        return jax.tree.map(stamp, pool)
    pool = tkvc.init_paged_pool(tget_config(LITE), num_blocks, block_size,
                                device="cpu")
    for a in tkvc._pool_arrays(pool):
        ids = torch.arange(a.shape[1], dtype=a.dtype)
        a.copy_(ids.reshape((1, -1) + (1,) * (a.ndim - 2)).expand_as(a))
    return pool


def _empty_pool(pkg, num_blocks, block_size=4):
    if pkg == "ref":
        return rkvc.init_paged_pool(get_config(LITE), num_blocks, block_size)
    return tkvc.init_paged_pool(tget_config(LITE), num_blocks, block_size,
                                device="cpu")


def _leaves(pkg, pool):
    if pkg == "ref":
        return [np.asarray(x, np.float32) for x in jax.tree.leaves(pool)]
    return [a.float().numpy() for a in tkvc._pool_arrays(pool)]


def _assert_dst_holds_src_ids(pkg, dst_pool, table, dst_table):
    for arr in _leaves(pkg, dst_pool):
        for s, d in zip(table, dst_table):
            np.testing.assert_array_equal(
                arr[:, d], np.full_like(arr[:, d], float(s)))


def _migrate_moves(pkg):
    kvc = M[pkg].kvc
    sa, da = kvc.BlockAllocator(8), kvc.BlockAllocator(8)
    src, dst = _stamped_pool(pkg, 8), _empty_pool(pkg, 8)
    table = kvc.reserve_blocks(sa, 3)
    dst_table, dst = kvc.migrate_blocks(sa, src, da, dst, table)
    assert len(dst_table) == 3 and kvc.PAD_BLOCK not in dst_table
    assert sa.free_blocks() == sa.capacity
    assert da.used_blocks() == 3
    assert all(da.refcount(b) == 1 for b in dst_table)
    _assert_dst_holds_src_ids(pkg, dst, table, dst_table)
    return table, dst_table


test_migrate_blocks_moves_data_and_refcounts = _on_both(_migrate_moves)


@pytest.mark.parametrize("pkg", PKGS)
def test_migrate_blocks_empty_table_is_a_noop(pkg):
    kvc = M[pkg].kvc
    sa, da = kvc.BlockAllocator(4), kvc.BlockAllocator(4)
    src, dst = _stamped_pool(pkg, 4), _empty_pool(pkg, 4)
    dst_table, out = kvc.migrate_blocks(sa, src, da, dst, [])
    assert dst_table == [] and out is dst
    assert sa.free_blocks() == sa.capacity
    assert da.free_blocks() == da.capacity


@pytest.mark.parametrize("pkg", PKGS)
def test_migrate_blocks_rejects_pad_block(pkg):
    kvc = M[pkg].kvc
    sa, da = kvc.BlockAllocator(4), kvc.BlockAllocator(4)
    src, dst = _stamped_pool(pkg, 4), _empty_pool(pkg, 4)
    with pytest.raises(AssertionError, match="pad block"):
        kvc.migrate_blocks(sa, src, da, dst, [kvc.PAD_BLOCK])


@pytest.mark.parametrize("pkg", PKGS)
def test_migrate_blocks_atomic_when_destination_exhausted(pkg):
    kvc = M[pkg].kvc
    sa, da = kvc.BlockAllocator(8), kvc.BlockAllocator(4)
    src, dst = _stamped_pool(pkg, 8), _empty_pool(pkg, 4)
    held = kvc.reserve_blocks(da, 2)
    table = kvc.reserve_blocks(sa, 3)
    src_refs, dst_refs = sa.refs_snapshot(), da.refs_snapshot()
    before = _leaves(pkg, dst)
    with pytest.raises(kvc.OutOfBlocks):
        kvc.migrate_blocks(sa, src, da, dst, table)
    assert sa.refs_snapshot() == src_refs
    assert da.refs_snapshot() == dst_refs
    assert da.free_blocks() == da.capacity - len(held)
    for a, b in zip(before, _leaves(pkg, dst)):
        np.testing.assert_array_equal(a, b)


def _randomized_conservation(pkg):
    import random
    kvc = M[pkg].kvc
    rng = random.Random(1234)
    sa, da = kvc.BlockAllocator(20), kvc.BlockAllocator(20)
    src, dst = _stamped_pool(pkg, 20), _empty_pool(pkg, 20)
    shared_held, dst_held, log = [], [], []
    for _ in range(5):
        n = rng.randrange(1, 4)
        mask = [rng.random() < 0.5 for _ in range(n)]
        sf, df = sa.free_blocks(), da.free_blocks()
        table = kvc.reserve_blocks(sa, n)
        shared = [b for b, s in zip(table, mask) if s]
        for b in shared:
            sa.incref(b)
        dst_table, dst = kvc.migrate_blocks(sa, src, da, dst, table)
        assert len(set(dst_table)) == n and da.free_blocks() == df - n
        assert all(da.refcount(b) == 1 for b in dst_table)
        for b in table:
            assert sa.refcount(b) == (1 if b in shared else 0)
        assert sa.free_blocks() == sf - len(shared)
        _assert_dst_holds_src_ids(pkg, dst, table, dst_table)
        shared_held += shared
        dst_held += dst_table
        log.append((table, dst_table))
    for b in shared_held:
        sa.decref(b)
    for b in dst_held:
        da.decref(b)
    assert sa.free_blocks() == sa.capacity
    assert da.free_blocks() == da.capacity
    return log


test_migrate_blocks_randomized_conservation = _on_both(
    _randomized_conservation)


def _migration_monolithic(pkg):
    dense = _llm(pkg, "dn", max_len=128)
    pe = _llm(pkg, "pe", max_len=128, paged=True, block_size=8)
    de = pe.clone(1)
    prompts = [("s0", "alpha beta gamma delta epsilon"),
               ("s1", " ".join(f"word{i}" for i in range(18)))]
    for sid, text in prompts:
        dense.op_prefill([{"sid": sid, "text": text}])
        pe.op_prefill([{"sid": sid, "text": text}])
    expect = {sid: dense.op_decode([{"sid": sid, "max_new": 8}])[0]
              for sid, _ in prompts}
    total = sum(len(pe.states[sid].table) for sid, _ in prompts)
    for sid, _ in prompts:
        assert de.import_seq(pe.export_seq(sid)) is None
        assert sid not in pe.states
    assert pe.alloc.free_blocks() == pe.alloc.capacity
    assert de.alloc.used_blocks() == total
    assert de.stats["migrations_in"] == 2
    assert de.stats["migrated_blocks"] == total
    outs = {sid: de.op_decode([{"sid": sid, "max_new": 8}])[0]
            for sid, _ in prompts}
    assert outs == expect
    return outs


test_engine_migration_token_identical_monolithic = _on_both(
    _migration_monolithic)


def _migration_mid_flight(pkg):
    text = " ".join(f"w{i}" for i in range(20))
    dense = _llm(pkg, "dn", max_len=128)
    dense.op_prefill([{"sid": "s", "text": text}])
    expect = dense.op_decode([{"sid": "s", "max_new": 8}])[0]
    pe = _llm(pkg, "pe", max_len=128, paged=True, block_size=8,
              chunked_prefill=True, prefill_chunk=8)
    de = pe.clone(1)
    st, toks, ptoks = pe._prepare_prefill_task({"sid": "s", "text": text})
    job = M[pkg].loop.PrefillJob("s", st, toks, ptoks=ptoks)
    pe._prefill_chunk_step([(job, 8)])
    assert 0 < job.cursor < len(toks)
    handle = pe.export_seq("s")
    handle["job"] = job
    cont = de.import_seq(handle)
    assert cont is not None and cont.remaining() == len(toks) - job.cursor
    cont.wait(120)
    job.wait(10)
    assert "s" not in pe.states
    assert pe.alloc.free_blocks() == pe.alloc.capacity
    sq = de.submit_decode("s", 8)
    assert sq.wait(120)
    assert sq.result == expect
    de.stop_decode_loop()
    pe.stop_decode_loop()
    return sq.result


test_engine_migration_mid_flight_chunked_prefill = _on_both(
    _migration_mid_flight)


def _migration_radix(pkg):
    shared = " ".join(f"c{i}" for i in range(16))
    pe = _llm(pkg, "pe", max_len=256, paged=True, block_size=8,
              prefix_cache="radix")
    de = pe.clone(1)
    pe.op_prefill([{"sid": "s0", "text": shared + " alpha beta"}])
    cached = list(pe.radix.block_snapshot())
    assert cached
    assert all(pe.alloc.refcount(b) == 2 for b in cached)
    de.import_seq(pe.export_seq("s0"))
    assert pe.radix.block_snapshot() == cached
    assert all(pe.alloc.refcount(b) == 1 for b in cached)
    assert pe.alloc.used_blocks() == len(cached)
    hits0 = pe.radix.stats["hits"]
    pe.op_prefill([{"sid": "s1", "text": shared + " gamma delta"}])
    assert pe.radix.stats["hits"] > hits0
    assert de.radix.num_blocks() == 0
    return de.op_decode([{"sid": "s0", "max_new": 6}])[0]


test_engine_migration_preserves_radix_cached_source_blocks = _on_both(
    _migration_radix)


def _import_backpressure(pkg):
    text = " ".join(f"y{i}" for i in range(20))
    pe = _llm(pkg, "pe", max_len=128, paged=True, block_size=8)
    pe.op_prefill([{"sid": "s", "text": text}])
    nb = len(pe.states["s"].table)
    de = _llm(pkg, "de", max_len=128, paged=True, block_size=8,
              num_blocks=nb + 1)
    de.ALLOC_TIMEOUT = 0.2
    de.op_prefill([{"sid": "bg", "text": text}])
    assert de.alloc.free_blocks() == 0
    handle = pe.export_seq("s")
    dst_refs = de.alloc.refs_snapshot()
    with pytest.raises(M[pkg].kvc.OutOfBlocks):
        de.import_seq(handle)
    assert "s" in pe.states and pe.alloc.used_blocks() == nb
    assert de.alloc.refs_snapshot() == dst_refs
    de.release("bg")
    assert de.import_seq(handle) is None
    assert "s" not in pe.states and de.alloc.used_blocks() == nb
    return nb


test_engine_import_backpressure_is_atomic = _on_both(_import_backpressure)
