"""The port's dry run (python -m repro_torch.launch.dryrun, a process of its
own: it opens a fake process group of 256 or 512 ranks) held to the
reference dry-run test's assertions (test_dryrun.py), and its argument
bytes to rank 0's slices as ``shard_tree`` and ``init_cache`` cut
them."""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import shard_rules as sr  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.serving.kv_cache import init_cache  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _run(args, out):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun"] + args +
        ["--out", str(out)], env={**os.environ, "PYTHONPATH": SRC},
        capture_output=True, text=True, timeout=300)


def _rank0_bytes(arch, shape, mesh):
    """Bytes of rank 0's slices of the decode step's arguments: the bf16
    params (shard_tree), the cache (init_cache under the mesh) and the
    token column (data_spec)."""
    cfg, ish = get_config(arch), INPUT_SHAPES[shape]
    params = sr.shard_tree(param_shapes(cfg, torch.bfloat16), mesh, 0,
                           sr.model_specs(cfg, mesh))
    cache = init_cache(cfg, ish.global_batch, ish.seq_len, chunk=1,
                       device="meta", mesh=mesh)
    toks = math.prod(sr.local_slice(
        torch.empty((ish.global_batch, 1), device="meta"),
        sr.data_spec(mesh, (ish.global_batch, 1)), mesh, 0).shape) * 4
    return toks + sum(t.numel() * t.element_size()
                      for t in tree_leaves(params) + tree_leaves(cache))


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
def test_dryrun_one_case_single_and_multipod(tmp_path, multi_pod):
    r = _run(["--arch", "tinyllama-1.1b", "--shape", "decode_32k"]
             + (["--multi-pod"] if multi_pod else []), tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    files = os.listdir(tmp_path)
    assert len(files) == 1
    rec = json.load(open(tmp_path / files[0]))
    assert rec["status"] == "ok"
    assert rec["devices"] == (512 if multi_pod else 256)
    t = rec["roofline_terms_s"]
    assert all(v >= 0 for v in t.values())
    assert rec["dominant_term"] in t
    args = rec["memory_analysis"]["argument_size_in_bytes"]
    assert args > 0
    # roofline inputs present
    assert rec["per_device"]["analytic_flops"] > 0
    assert rec["per_device"]["collective_bytes"] > 0
    assert rec["per_device"]["collective_bytes"] == \
        sum(rec["per_device"]["collectives_by_type"].values())
    # a 1.1B model's bf16 weights fit 256+ chips easily
    assert args < 2 ** 32
    mesh = abstract_mesh((2, 16, 16) if multi_pod else (16, 16),
                         ("pod", "data", "model") if multi_pod else
                         ("data", "model"))
    assert args == _rank0_bytes("tinyllama-1.1b", "decode_32k", mesh)


def test_skip_note_for_full_attention_long_context(tmp_path):
    r = _run(["--arch", "deepseek-67b", "--shape", "long_500k"], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SKIP" in r.stdout
