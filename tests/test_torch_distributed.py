"""The port's sharded path on 8 CPU ranks (gloo), held against the port's
own single-device path, which the other test files hold against the
reference: the reference's sharded train and decode tests fail inside
the reference under the installed JAX (test_distributed.py), so they
cannot be the oracle. The reference's ``routed_ep`` does run, and is the
oracle of the expert-parallel case that drops tokens.

The 8 ranks are spawned once for the file (this file, run as a script, is
the rank program; a ``file://`` store under the test's tmp dir, no fixed
port) and run every case in one process group; each writes its errors to
a JSON file that the tests read. The reference's ``routed_ep`` runs
meanwhile in a JAX subprocess on 8 forced host devices.

Cases and tolerances:
  - the four collectives of models/sharding.py, exact: their values over
    one axis and over two, the bytes they count, and the gather's
    backward (a reduce-scatter of every rank's cotangent);
  - a reduced TinyLlama train step (fp32, 2 microbatches) at (4, 2)
    against the single-device step: loss rtol 2e-4 (the reference's),
    gnorm 1e-5 relative, each updated moment leaf 1e-5 of its largest
    magnitude, each updated param leaf 1e-5 of its largest magnitude
    where its gradient is above FIRM = 1e-2 of the leaf's largest, and
    within 2 lr elsewhere: Adam's first step moves a param by
    lr * g / (|g| + eps), so where |g| comes within a few thousand eps
    (1e-8) the step depends on |g| itself, which float32 summation order
    moves, and a gradient near 0 can take either sign (the zero-init norm
    leaves' gradients reach down there);
  - a reduced Gemma-2 prefill of 15 tokens plus one decode token at
    (4, 2) against single-device logits, within 3e-3 (the reference's),
    on the reference's cache layout (the sequence over 'model');
  - a reduced TinyLlama with num_kv_heads = 1 at model = 2: the one KV
    head whole on every rank, the sequence split, 3e-3;
  - the sequence layout: a reduced TinyLlama prefilled in two chunks
    whose prefix crosses a rank's slots, at B = 8 and at B = 1 (the
    sequence over ('data', 'model')), a chunk past the cache's end (the
    global clamp), Gemma-2's local layers on a ring that wraps, and
    ``write_linear`` on each slice against the whole write, exact;
  - reduced RWKV-6 (time mix over heads, channel mix over f), Hymba
    (Mamba over dI) and DeepSeek-V3's MLA layers (over heads, the
    compressed cache over the sequence) at (4, 2): prefill, partial
    prefill and decode logits within 3e-3; one RWKV-6 train step as the
    TinyLlama one below, in float64 (its K6 scan in float32, as always):
    in float32 the reduced RWKV-6 step moves its moments by 4.9e-5 of
    their scale when its params move by 1e-7 of theirs, so any other
    order of its float32 sums, the tensor-parallel split's included,
    exceeds the 1e-5 below; in float64 the split is held to it;
  - expert parallelism against ``routed_dense_plain`` at capacity factor
    16 (no drops): 4 experts over model = 2, 6 over model = 4 (padded to
    8), 8 under ep_all_axes + resident_weights: 3e-4 (the reference's);
    and the EP aux equal to the mean of each rank's slice's
    load-balance loss (1e-6);
  - EP at capacity factor 1.0, where tokens are dropped, against the
    reference's ``routed_ep`` on the same inputs: 3e-4;
  - a reduced Qwen1.5-MoE train step under EP at (4, 2) against the
    single-device step, within 1e-5 (as above). The MoE aux loss is
    weighted 0 in both: the reference averages each rank's aux under EP,
    which is not the single-device batch's aux (the aux itself is held
    in the EP case above).
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 8
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
FIRM = 1e-2
T_EP = 32                            # tokens of the EP cases (4 per rank)

REF_EP = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config
from repro.models import moe
d = dict(np.load(sys.argv[1]))
base = get_config('qwen2-moe-a2.7b').reduced()
cfg = dataclasses.replace(base, moe=dataclasses.replace(
    base.moe, num_experts=4, top_k=2, capacity_factor=1.0))
p = {k: jnp.asarray(d[k]) for k in ('router', 'w_gate', 'w_up', 'w_down')}
mesh = jax.make_mesh((4, 2), ('data', 'model'))
out, aux = jax.jit(lambda x: moe.routed_ep(cfg, p, x, mesh))(
    jnp.asarray(d['x']))
np.savez(sys.argv[2], out=np.asarray(out), aux=np.asarray(aux))
"""


def ep_inputs(cfg_d: int, E: int, f: int, seed: int):
    """numpy-seeded MoE weights and tokens, the same on every rank and in
    the reference's process."""
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((cfg_d, E)) / cfg_d ** 0.5),
            "w_gate": rng.standard_normal((E, cfg_d, f)) / cfg_d ** 0.5,
            "w_up": rng.standard_normal((E, cfg_d, f)) / cfg_d ** 0.5,
            "w_down": rng.standard_normal((E, f, cfg_d)) / f ** 0.5,
            "x": rng.standard_normal((T_EP, cfg_d))}


# ---------------------------------------------------------------------------
# the rank program

def _rank_main(rank: int, store: str, out_dir: str):
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.launch import optflags
    from repro_torch.launch import shard_rules as sr
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map
    from repro_torch.models.sharding import (COUNTER, all_gather,
                                             all_reduce, all_to_all,
                                             local_slice, mesh_context,
                                             reduce_scatter)
    from repro_torch.models.transformer import apply_model, init_params
    from repro_torch.serving.kv_cache import init_cache
    from repro_torch.training import train_step as tts
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    m42, m24 = make_local_mesh(4, 2), make_local_mesh(2, 4)
    res = {}

    def params_of(cfg, dtype=torch.float32):
        return init_params(cfg, torch.Generator().manual_seed(0), dtype,
                           "cpu")

    def train_case(cfg, mesh, dtype=torch.float32):
        params = params_of(cfg, dtype)
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 17)))
        opt_cfg = AdamWConfig(warmup_steps=1)
        step = tts.make_train_step(cfg, opt_cfg, num_microbatches=2,
                                   compute_dtype=dtype)
        p1 = tree_map(torch.clone, params)
        p1, o1, m1 = step(p1, init_opt_state(opt_cfg, p1), {"tokens": toks})
        with mesh_context(mesh):
            specs = sr.model_specs(cfg, mesh)
            p2 = sr.shard_tree(params, mesh, specs=specs)
            b2 = {"tokens": sr.shard_batch(toks, mesh)}
            p2, o2, m2 = step(p2, init_opt_state(opt_cfg, p2), b2)
        out = {"loss": [float(m1["loss"]), float(m2["loss"])],
               "gnorm": [float(m1["gnorm"]), float(m2["gnorm"])],
               "moments": 0.0, "params": 0.0, "params_soft": 0.0,
               "lr": float(opt_cfg.lr)}
        lr = float(opt_cfg.lr)

        def leaf(full_p, loc_p, full_m, loc_m, full_v, loc_v, spec):
            for full, loc in ((full_m, loc_m), (full_v, loc_v)):
                want = local_slice(full, spec, mesh)
                scale = float(full.abs().max()) or 1.0
                out["moments"] = max(out["moments"], float(
                    (loc - want).abs().max()) / scale)
            want = local_slice(full_p, spec, mesh)
            g = local_slice(full_m, spec, mesh).abs()
            firm = g > FIRM * float(full_m.abs().max())
            err = (loc_p - want).abs()
            scale = float(full_p.abs().max()) or 1.0
            out["params"] = max(out["params"], float(
                torch.where(firm, err, 0).max()) / scale)
        # tree_map walks the first tree's structure: a spec is a leaf
        tree_map(leaf, p1, p2, o1["m"], o2["m"], o1["v"], o2["v"], specs)
        return out

    def serve_case(cfg, mesh, sched, B=8, max_len=32, chunk=256):
        """The calls ``sched`` ((lo, hi) token ranges, each at pos lo) on
        one device and sharded; the largest logit difference of each
        call, the largest logit, and the local shapes of the first
        layer's cache leaves."""
        params = params_of(cfg)
        rng = np.random.default_rng(2)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (B, sched[-1][1])))
        cache = init_cache(cfg, B, max_len, chunk=chunk, device="cpu")
        want = []
        for lo, hi in sched:
            logits, cache = apply_model(cfg, params, toks[:, lo:hi], cache,
                                        lo)
            want.append(sr.shard_batch(logits, mesh))
        with mesh_context(mesh):
            p2 = sr.shard_tree(params, mesh,
                               specs=sr.model_specs(cfg, mesh))
            c2 = init_cache(cfg, B, max_len, chunk=chunk, device="cpu")
            t2 = sr.shard_batch(toks, mesh)
            got = []
            for lo, hi in sched:
                logits, c2 = apply_model(cfg, p2, t2[:, lo:hi], c2, lo,
                                         cache_batch=B)
                got.append(logits)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        return {"errs": errs, "prefill": max(errs[:-1]), "decode": errs[-1],
                "scale": max(float(w.abs().max()) for w in want),
                "shapes": {k: list(v.shape) for k, v in
                           c2["stages"][0][0].items()}}

    def decode_case(cfg, mesh):
        r = serve_case(cfg, mesh, [(0, 15), (15, 16)])
        r["kv_shape"] = r["shapes"]["k"]
        return r

    def write_clamp_case(mesh):
        """write_linear on each rank's sequence slice (over 'model', and
        over ('data', 'model')) against the whole cache's write, for a
        chunk that runs past the end (the reference's clamp to T - S) and
        one inside; per-sequence positions."""
        from repro_torch.serving.kv_cache import write_linear
        buf = torch.arange(2 * 32 * 3, dtype=torch.float32).reshape(2, 32, 3)
        chunk = -torch.arange(1, 2 * 8 * 3 + 1,
                              dtype=torch.float32).reshape(2, 8, 3)
        ok = True
        for pos in (torch.tensor([28, 5]), 30):
            whole = write_linear(buf.clone(), chunk, pos)
            for axes in ("model", ("data", "model")):
                g, i = mesh.group_size(axes), mesh.index(axes)
                n = 32 // g
                mine = write_linear(buf[:, i * n:(i + 1) * n].clone(), chunk,
                                    pos, seq=(i * n, 32))
                ok &= torch.equal(mine, whole[:, i * n:(i + 1) * n])
        return ok

    def ep_case(E, mesh, flags, cf=16.0, seed=3, ref=None):
        optflags.set_flags(flags)
        base = get_config("qwen2-moe-a2.7b").reduced()
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, num_experts=E, top_k=2, capacity_factor=cf))
        d = ep_inputs(cfg.d_model, E, cfg.moe.d_expert, seed)
        p = {k: torch.tensor(v, dtype=torch.float32) for k, v in d.items()
             if k != "x"}
        x = torch.tensor(d["x"], dtype=torch.float32)
        dense, _ = moe.routed_dense_plain(cfg, p, x)
        toks = ("data", "model")
        n = T_EP // mesh.size
        with mesh_context(mesh):
            specs = {k: sr.param_spec(("moe", k), v.shape, mesh)
                     for k, v in p.items()}
            local = {k: local_slice(v, specs[k], mesh).clone()
                     for k, v in p.items()}
            i = mesh.index(toks)
            out, aux = moe.routed_ep(cfg, local, x[i * n:(i + 1) * n], mesh,
                                     specs)
            full = all_gather(out, toks, 0)
        slices = [moe.aux_load_balance_loss(
            cfg, moe.router_probs(cfg, p["router"], x[j * n:(j + 1) * n])[2],
            moe.router_probs(cfg, p["router"], x[j * n:(j + 1) * n])[1])
            for j in range(mesh.size)]
        optflags.set_flags([])
        r = {"dense": float(((full - dense).abs()
                             - 3e-4 * dense.abs()).max()),
             "dense_abs": float((full - dense).abs().max()),
             "aux": abs(float(aux) - float(torch.stack(slices).mean())),
             "experts_local": list(local["w_gate"].shape)}
        if ref is not None:
            want = torch.from_numpy(ref["out"])
            r["ref"] = float(((full - want).abs()
                              - 3e-4 * want.abs()).max())
            r["ref_aux"] = abs(float(aux) - float(ref["aux"]))
        return r

    def collectives_case(mesh):
        """The four doors' values and byte counts over one and two axes,
        and the gather's backward (a reduce-scatter) against the sum of
        every rank's cotangent."""
        def val(r, shape):
            return torch.arange(float(math.prod(shape))).reshape(shape) \
                + 100 * r
        both = ("data", "model")
        me, ranks = mesh.rank, range(mesh.size)
        model_peers = [r for r in ranks if mesh.coords(r)["data"] ==
                       mesh.coords()["data"]]
        data_peers = [r for r in ranks if mesh.coords(r)["model"] ==
                      mesh.coords()["model"]]
        ok = {}
        COUNTER.reset()
        with mesh_context(mesh):
            x = val(me, (2, 3))
            ok["gather_both"] = torch.equal(all_gather(x, both, 0), torch.cat(
                [val(r, (2, 3)) for r in ranks]))
            ok["gather_model_dim1"] = torch.equal(
                all_gather(x, "model", 1),
                torch.cat([val(r, (2, 3)) for r in model_peers], 1))
            ok["reduce_data"] = torch.equal(
                all_reduce(x, "data"), sum(val(r, (2, 3))
                                           for r in data_peers))
            y = val(me, (4, 3))
            i = mesh.index("model")
            ok["reduce_scatter_model"] = torch.equal(
                reduce_scatter(y, "model", 0),
                sum(val(r, (4, 3)) for r in model_peers)[2 * i:2 * i + 2])
            z = torch.stack([torch.full((2,), 100. * me + j)
                             for j in range(mesh.size)])
            got = all_to_all(z, both)
            ok["all_to_all_both"] = torch.equal(got, torch.stack(
                [torch.full((2,), 100. * r + mesh.index(both))
                 for r in ranks]))
            ok["bytes"] = COUNTER.bytes == {
                "all-gather": (16 * 3 + 2 * 6) * 4, "all-reduce": 6 * 4,
                "reduce-scatter": 6 * 4, "all-to-all": 8 * 2 * 4}
            x = val(me, (2, 3)).requires_grad_(True)
            (all_gather(x, "model", 0) * val(me, (4, 3))).sum().backward()
            ok["gather_backward"] = torch.equal(x.grad, sum(
                val(r, (4, 3)) for r in model_peers)[2 * i:2 * i + 2])
        return ok

    res["collectives"] = collectives_case(m42)
    res["train_tinyllama"] = train_case(
        get_config("tinyllama-1.1b").reduced(), m42)
    res["decode_gemma2"] = decode_case(get_config("gemma2-9b").reduced(),
                                       m42)
    res["decode_mqa"] = decode_case(
        get_config("tinyllama-1.1b").reduced(num_kv_heads=1), m42)
    two_chunks = [(0, 10), (10, 20), (20, 21)]   # the prefix crosses 16
    tiny = get_config("tinyllama-1.1b").reduced()
    res["seq_tinyllama"] = serve_case(tiny, m42, two_chunks)
    res["seq_tinyllama_b1"] = serve_case(tiny, m42, two_chunks, B=1)
    optflags.set_flags(["flat_dp"])   # the batch over every axis
    res["seq_tinyllama_flat_dp"] = serve_case(tiny, m42, two_chunks)
    optflags.set_flags([])
    res["seq_clamp"] = serve_case(tiny, m42, [(0, 20), (20, 36),
                                             (36, 37)])
    res["write_clamp"] = write_clamp_case(m42)
    # Gemma-2's local layers on a ring of 256 slots that wraps (window 64,
    # chunks of up to 150 tokens, positions to 310)
    res["ring_gemma2"] = serve_case(
        get_config("gemma2-9b").reduced(), m42,
        [(0, 150), (150, 300), (300, 301), (301, 302)], max_len=512,
        chunk=150)
    sched = [(0, 10), (10, 15), (15, 16)]
    res["serve_rwkv"] = serve_case(get_config("rwkv6-3b").reduced(), m42,
                                   sched)
    res["serve_hymba"] = serve_case(get_config("hymba-1.5b").reduced(), m42,
                                    sched)
    dsv3 = get_config("deepseek-v3-671b").reduced()
    mla = dataclasses.replace(dsv3, stages=(dataclasses.replace(
        dsv3.stages[0], repeat=2),))             # its dense-FFN MLA layers
    res["serve_mla"] = serve_case(mla, m42, sched)
    res["train_rwkv"] = train_case(get_config("rwkv6-3b").reduced(), m42,
                                   torch.float64)
    res["ep_4_model2"] = ep_case(4, m42, [])
    res["ep_6_model4"] = ep_case(6, m24, [])
    res["ep_8_all_axes"] = ep_case(8, m24, ["ep_all_axes",
                                            "resident_weights"])
    base = get_config("qwen2-moe-a2.7b").reduced()
    qwen = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=16.0))
    tts.AUX_COEF = 0.0
    res["train_qwen_ep"] = train_case(qwen, m42)
    res["ep_drop_vs_reference"] = ep_case(
        4, m42, [], cf=1.0, seed=4,
        ref=dict(np.load(os.path.join(out_dir, "ep_ref_out.npz"))))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.configs.base import get_config
    out = tmp_path_factory.mktemp("dist")
    # at the reduced Qwen's widths, which the reference's process builds
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    inputs = ep_inputs(cfg.d_model, 4, cfg.moe.d_expert, 4)
    np.savez(out / "ep_ref_in.npz",
             **{k: v.astype(np.float32) for k, v in inputs.items()})
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    ref = subprocess.run(
        [sys.executable, "-c", REF_EP, str(out / "ep_ref_in.npz"),
         str(out / "ep_ref_out.npz")], env=env, capture_output=True,
        text=True, timeout=300)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r),
         str(out / "store"), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    return [json.load(open(out / f"rank{r}.json")) for r in range(WORLD)]


def test_all_ranks_ran_every_case(ranks):
    assert len(ranks) == WORLD
    assert all(r.keys() == ranks[0].keys() for r in ranks)


def test_collectives_values_bytes_and_adjoint(ranks):
    for r in ranks:
        assert all(r["collectives"].values()), r["collectives"]


def _train_ok(ranks, case):
    for r in ranks:
        t = r[case]
        loss1, loss2 = t["loss"]
        assert abs(loss1 - loss2) <= 2e-4 * abs(loss1), t
        g1, g2 = t["gnorm"]
        assert abs(g1 - g2) <= 1e-5 * g1, t
        assert t["moments"] <= 1e-5, t
        assert t["params"] <= 1e-5, t
        assert t["params_soft"] <= 2.0, t


def test_sharded_train_step_matches_single_device(ranks):
    _train_ok(ranks, "train_tinyllama")


def test_sharded_decode_matches_single_device(ranks):
    for r in ranks:
        t = r["decode_gemma2"]
        assert t["prefill"] <= 3e-3 and t["decode"] <= 3e-3, t
        # (R, B, T, K, hd): 8 sequences over data = 4, the 32 slots over
        # model = 2, every KV head
        assert t["kv_shape"][1:4] == [2, 16, 4], t


def test_replicated_kv_head_mqa(ranks):
    """num_kv_heads = 1 at model = 2: the cache splits the sequence, not
    the heads, so every rank holds the one KV head of its slots."""
    for r in ranks:
        t = r["decode_mqa"]
        assert t["prefill"] <= 3e-3 and t["decode"] <= 3e-3, t
        assert t["kv_shape"][3] == 1        # the one KV head on each rank


@pytest.mark.parametrize("case,slots", [
    ("seq_tinyllama", 16), ("seq_tinyllama_b1", 4), ("seq_clamp", 16),
    ("ring_gemma2", 128), ("seq_tinyllama_flat_dp", 32)])
def test_sequence_layout_matches_single_device(ranks, case, slots):
    """The reference's cache layout: the sequence over 'model' (16 of 32
    slots), or over ('data', 'model') at B = 1 (4 of 32), the prefix of
    the second chunk crossing a rank's boundary; a chunk clamped to the
    cache's end (T - S, the reference's global clamp); Gemma-2's local
    layers on a wrapping ring of 256 slots (128 per rank); under flat_dp,
    where the batch takes 'model' and the sequence stays whole (32)."""
    for r in ranks:
        t = r[case]
        assert max(t["errs"]) <= 3e-3, t
        assert t["shapes"]["k"][2] == slots, t


def test_sharded_write_linear_clamp(ranks):
    for r in ranks:
        assert r["write_clamp"], r["write_clamp"]


@pytest.mark.parametrize("case,leaf,dim,local", [
    ("serve_rwkv", "state", 2, 4), ("serve_hymba", "ssm_h", 2, 128),
    ("serve_mla", "ckv", 2, 16)])
def test_tensor_parallel_recurrent_and_mla(ranks, case, leaf, dim, local):
    """Reduced RWKV-6 (8 heads), Hymba (dI 256) and DeepSeek-V3's MLA
    layers at (4, 2): prefill, partial prefill and decode logits against
    one device; the state holds H / tp heads, ssm_h dI / tp, ckv half
    the sequence."""
    for r in ranks:
        t = r[case]
        assert max(t["errs"]) <= 3e-3, t
        assert t["shapes"][leaf][dim] == local, t


def test_sharded_rwkv_train_step_matches_single_device(ranks):
    _train_ok(ranks, "train_rwkv")


@pytest.mark.parametrize("case,stored", [("ep_4_model2", 2),
                                         ("ep_6_model4", 6),
                                         ("ep_8_all_axes", 1)])
def test_ep_matches_dense(ranks, case, stored):
    """``stored``: the experts each rank holds of the leaf (6 does not
    split over 4, so each rank holds all 6 and cuts its 2 of the 8
    padded ones)."""
    for r in ranks:
        t = r[case]
        assert t["dense"] <= 3e-4, t
        assert t["aux"] <= 1e-6, t
        assert t["experts_local"][0] == stored, t


def test_ep_capacity_drop_matches_reference(ranks):
    for r in ranks:
        t = r["ep_drop_vs_reference"]
        assert t["ref"] <= 3e-4, t
        assert t["ref_aux"] <= 1e-6, t
        assert t["dense_abs"] > 1e-3, t     # tokens were dropped


def test_ep_train_step_matches_single_device(ranks):
    _train_ok(ranks, "train_qwen_ep")


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
