"""The port's examples (``repro_torch/examples/``) run on the CPU engines
(``--device cpu``) and print what tests/test_examples.py holds the
reference's examples to; ``colocated_apps`` answers every query of both
apps. (``train_tiny``: tests/test_torch_train.py.) On the card they run in
chip_smoke.py's ``[examples]`` phase."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import colocated_apps, quickstart  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402


def test_quickstart(capsys):
    quickstart.main(device="cpu")
    out = capsys.readouterr().out
    assert "optimized e-graph" in out
    assert "end-to-end latency" in out


def test_serve_batched(capsys):
    serve_batched.main(3, device="cpu")
    out = capsys.readouterr().out
    assert "served 3 queries" in out
    assert "topology-aware batching" in out


def test_colocated_apps_answer_every_query(capsys):
    answers = colocated_apps.main(device="cpu")
    out = capsys.readouterr().out
    assert sorted(answers) == ["rag", "search_gen"]
    for app, texts in answers.items():
        assert len(texts) == 3 and all(
            isinstance(t, str) and t for t in texts), (app, texts)
        assert f"{app:12s} avg latency" in out
