"""The yardstick's arithmetic: interval unions and the idle share, the
profiled slice's summary, the frozen work functions against the port's
kernel table, the model FLOPs of a token, and the readers found by name
(a configuration, a mix and a metric added only as files)."""
import json

import pytest

from .benchtree import BENCH, QWEN, tiny_tree
from harness import cells, stats, trace, work


def test_union_and_clip():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.union_length(stats.clip(iv, 1.5, 3.5)) == pytest.approx(1.0)
    assert stats.union_length([]) == 0.0


def test_summary_busy_and_gaps():
    recs = [("void k_a<1>(float*)", 0.1, 0.3), ("k_b", 0.2, 0.4),
            ("void (anonymous namespace)::k_c<2>(int)", 0.9, 1.2)]
    s = trace.summarize(recs, 0.0, 1.0)
    assert s["busy_s"] == pytest.approx(0.4)
    gaps = dict(s["idle_gaps"])
    assert gaps["after slice start"] == pytest.approx(0.1)
    assert gaps["after k_b"] == pytest.approx(0.5)
    assert dict(s["device_ops"])["k_c<2>"] == pytest.approx(0.1)


def test_idle_share_reader():
    read = cells.reader(BENCH / "metrics", "device_idle_share.steady")
    run = {"slice": {"seconds": 2.0, "summary": {"busy_s": 0.5}}}
    assert read(run) == pytest.approx(75.0)
    assert read({"slice": None}) is None


@pytest.mark.parametrize("key,owner", [
    ("void teola::split_kv_split<teola::DenseKeys, 128>(x)",
     "decode_attention"),
    ("void teola::split_kv_combine<teola::PagedDecodeKeys>(y)",
     "paged_decode_attention"),
    ("void teola::ft::flash_tile_kernel<teola::ChunkPagedKeys, 128>(z)",
     "chunk_prefill_attention"),
    ("void (anonymous namespace)::rwkv6_decode_kernel<4>(w)", "rwkv6_scan"),
    ("ampere_sgemm_128x64_nn", None)])
def test_kernel_owner(key, owner):
    assert trace.kernel_owner(key) == owner


# the port's kernel table (PERF.md): TinyLlama-1.1B's heads (32 q, 4 kv,
# hd 64), batch 4, fp32 q, bf16 K/V, lengths 1/130/300/512 in 512 slots;
# K6 at RWKV-6 3B's heads (40 x 64), fp32, batch 4
LENGTHS = [1, 130, 300, 512]
KV_ROW = 4 * 64 * 2 * 2


def test_k2_bound_as_in_the_kernel_table():
    ms, by = work.bound_ms(*work.decode_work((4, 32, 64), 4, LENGTHS,
                                             KV_ROW, 512), work.FP32_FLOPS)
    assert (round(ms, 4), by) == (0.0003, "bytes")


def test_k4_bound_as_in_the_kernel_table():
    ms, by = work.bound_ms(*work.paged_work((4, 32, 64), 4,
                                            [[n - 1] for n in LENGTHS],
                                            KV_ROW), work.FP32_FLOPS)
    assert (round(ms, 4), by) == (0.0003, "bytes")


@pytest.mark.parametrize("S,bound,by", [(512, 0.0351, "operations"),
                                        (1, 0.0016, "bytes")])
def test_k6_bound_as_in_the_kernel_table(S, bound, by):
    ms, kind = work.bound_ms(*work.scan_work((4, S, 40, 64), 4,
                                             work.SCAN_OPS_TABLE),
                             work.FP32_FLOPS)
    assert (round(ms, 4), kind) == (bound, by)


def test_prefill_and_paged_work_agree_on_a_linear_cache():
    # one row, prefix 100, a 28-token chunk: K1 over a dense cache and K5
    # over a table read the same keys and do the same pairs
    b1, f1 = work.prefill_work((1, 28, 16, 128), 4, [100], 16 * 128 * 4,
                               512)
    b5, f5 = work.paged_work((1, 28, 16, 128), 4,
                             [list(range(100, 128))], 16 * 128 * 4)
    assert (b1, f1) == (b5, f5)


def test_token_flops_of_qwen():
    conf = json.loads(QWEN.read_text())
    f = work.token_flops(conf)
    # 24 layers of (4 d^2 attention + router + 4 x 3 d 1408 + 3 d 5632)
    per_layer = 4 * 2048 ** 2 + 2048 * 60 + 4 * 3 * 2048 * 1408 + \
        3 * 2048 * 5632
    assert f["body"] == 2 * 24 * per_layer
    assert f["head"] == 2 * 2048 * 151936
    # about 2 x the 2.0 B parameters a token activates outside the head
    assert 3.9e9 < f["body"] < 4.3e9


def test_roofline_reader_refuses_nothing_to_read():
    read = cells.reader(BENCH / "metrics", "attn_roofline.steady")
    assert read({"slice": None}) is None
    sl = {"owner_device_s": {}, "bounds": {}}
    assert read({"slice": sl}) is None
    sl = {"owner_device_s": {"decode_attention": 1e-6},
          "bounds": {"decode_attention": [(3.35e6, 0)]}}
    assert read({"slice": sl}) == pytest.approx(100.0)


def test_suffix_shares_a_reader():
    a = cells.reader(BENCH / "metrics", "decode_step_ms.serve")
    run = {"window": (0.0, 3.0),
           "decode_spans": [(0.0, 0.5, 4, 1), (1.0, 2.5, 16, 3),
                            (2.9, 3.2, 8, 1)]}
    assert a(run) == pytest.approx(500.0)


def test_files_added_by_name_are_found(tmp_path):
    """A later PR adds a configuration, a mix and a metric as files and
    entries only: the harness finds each by its name."""
    bench = tiny_tree(tmp_path)
    conf = json.loads((bench / "configs" / "tiny-qwen.json").read_text())
    (bench / "configs" / "tiny-qwen-b.json").write_text(
        json.dumps(dict(conf, name="tiny-qwen-b")))
    mix = json.loads((bench / "traffic" / "adv-rag.steady.json").read_text())
    (bench / "traffic" / "adv-rag.fresh.json").write_text(
        json.dumps(dict(mix, rate_qps=0.123)))
    (bench / "metrics" / "spans_per_query.steady.py").write_text(
        "def read(run):\n    return 42.0\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-qwen-b", "source": "x",
                         "file": "bench/configs/tiny-qwen-b.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "tiny-qwen-b.fresh",
                           "config": "tiny-qwen-b",
                           "traffic": "adv-rag.fresh", "chips": 1,
                           "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "query_p50_s":
            m["workloads"].append("tiny-qwen-b.fresh")
    b["per_layer"].append({"name": "spans_per_query.steady", "unit": "1",
                           "better": "lower", "source": "program_span",
                           "layer": "orchestration", "moves": "query_p50_s",
                           "workloads": ["tiny-qwen-b.fresh"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = cells.load(tmp_path, bench, "tiny-qwen-b.fresh")
    assert c["conf"]["name"] == "tiny-qwen-b"
    assert c["mix"]["rate_qps"] == 0.123
    assert {m["name"] for m in c["end_to_end"]} == {
        "setup_s", "query_p50_s"}
    assert [m["name"] for m in c["per_layer"]] == ["spans_per_query.steady"]
    assert c["readers"]["spans_per_query.steady"]({}) == 42.0


def test_a_metric_without_workloads_follows_what_it_moves(tmp_path):
    """Without a ``workloads`` key a per-layer metric is reported in every
    cell that reports what it moves: here in the cell that reports
    ``query_p50_s`` and not in one added without it."""
    bench = tiny_tree(tmp_path)
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append(dict(b["workloads"][0], name="tiny-qwen.other"))
    b["per_layer"].append({"name": "decode_step_ms.every", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "engines", "moves": "query_p50_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    here = {n: "decode_step_ms.every" in
            [m["name"] for m in cells.load(tmp_path, bench, n)["per_layer"]]
            for n in ("tiny-qwen.steady", "tiny-qwen.other")}
    assert here == {"tiny-qwen.steady": True, "tiny-qwen.other": False}


def test_benchmark_json_names_a_reader_for_every_metric():
    b = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for w in b["workloads"]:
        c = cells.load(BENCH.parent, BENCH, w["name"])
        assert c["readers"] and c["per_layer"]
