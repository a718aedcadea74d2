"""The traffic generator: the same inputs from the same seed, the same work
in another order from another, an open loop's exact rate, and latencies
taken from the scheduled send time."""
import json
from collections import Counter

import numpy as np
import pytest

from .benchtree import BENCH
from harness import cells, stats
from harness.traffic import Traffic

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))
BIG = 2 ** 31 + 12345


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_inputs(name):
    a, b = Traffic(_mix(name), BIG), Traffic(_mix(name), BIG)
    assert a.queries(40) == b.queries(40)
    assert a.docs == b.docs
    if _mix(name)["loop"] == "open":
        assert np.array_equal(a.open_schedule(51), b.open_schedule(51))


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_same_work_other_order(name):
    a, b = Traffic(_mix(name), BIG), Traffic(_mix(name), BIG + 1)
    qa, qb = a.queries(64), b.queries(64)
    pairs = Counter(tuple(q["doc_ids"]) for q in qa)
    assert pairs == Counter(tuple(q["doc_ids"]) for q in qb)
    assert [q["doc_ids"] for q in qa] != [q["doc_ids"] for q in qb]
    # the documents' values come from the seed, their lengths do not
    assert [d["text"] for d in a.docs] != [d["text"] for d in b.docs]
    assert [len(d["text"].split()) for d in a.docs] == \
        [len(d["text"].split()) for d in b.docs]


def test_queries_ask_about_their_first_document():
    t = Traffic(_mix("adv-rag.steady"), 7)
    for q in t.queries(50):
        assert len(q["docs"]) == 2 and len(set(q["doc_ids"])) == 2
        assert q["question"].endswith(q["docs"][0]["topic"])
        j = int(q["question"].split()[3])
        assert 0 <= j < 40 and f"Fact {j} about" in q["docs"][0]["text"]


def test_zipf_popularity():
    t = Traffic(dict(_mix("adv-rag.steady"), shape_seed=3), 1)
    counts = Counter(i for q in t.queries(4000) for i in q["doc_ids"])
    assert counts["doc0"] > counts["doc1"] > counts["doc3"] > counts["doc7"]


@pytest.mark.parametrize("rate,seconds", [(0.3, 51), (1.7, 20), (0.05, 10)])
def test_open_schedule_is_poisson_at_the_exact_rate(rate, seconds):
    mix = dict(_mix("adv-rag.steady"), rate_qps=rate)
    a = Traffic(mix, 1).open_schedule(seconds)
    b = Traffic(mix, 2).open_schedule(seconds)
    n = max(1, round(rate * seconds))
    assert len(a) == len(b) == n and a[0] == b[0] == 0.0
    assert np.all(np.diff(a) > 0) and a[-1] < seconds
    # one trace every seed replays; another mix shape, another trace
    assert np.array_equal(a, b)
    ga = np.sort(np.diff(np.append(a, seconds)))
    assert np.isclose(ga.sum(), seconds)
    c = Traffic(dict(mix, shape_seed=mix["shape_seed"] + 1),
                1).open_schedule(seconds)
    assert np.allclose(ga, np.sort(np.diff(np.append(c, seconds))))
    if n > 10:
        # exponential gaps: the coefficient of variation near 1
        assert 0.8 < ga.std() / ga.mean() < 1.2
        assert not np.array_equal(a, c)


def _run(rows, seconds=10.0):
    return {"queries": rows, "window": (0.0, seconds), "drain_end": 30.0}


def test_latency_from_the_scheduled_send():
    # the generator stalled: both queries were due at 0 and 1 but sent at
    # 4; they answered at 5 and 6
    rows = [{"sched": s, "submit": 4.0, "submitted": 4.0, "done": d,
             "ok": True, "latency_s": d - s, "spans": []}
            for s, d in ((0.0, 5.0), (1.0, 6.0))]
    assert stats.latencies(_run(rows)) == pytest.approx([5.0, 5.0])
    p50 = cells.reader(BENCH / "metrics", "query_p50_s")(_run(rows))
    assert p50 == pytest.approx(5.0)


def test_unanswered_queries_count_to_the_drain_end():
    rows = [{"sched": 0.0, "submit": 0.0, "submitted": 0.0, "done": 2.0,
             "ok": True, "latency_s": 2.0, "spans": []},
            {"sched": 1.0, "submit": 1.0, "submitted": 1.0, "done": None,
             "ok": False, "latency_s": None, "spans": []}]
    assert stats.latencies(_run(rows)) == pytest.approx([2.0, 29.0])
    p50 = cells.reader(BENCH / "metrics", "query_p50_s")(_run(rows))
    assert p50 == pytest.approx(2.0 + 0.5 * (29.0 - 2.0))


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_matches_numpy(q):
    xs = list(np.random.default_rng(q).exponential(3.0, 37))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
