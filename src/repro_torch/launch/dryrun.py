"""Multi-pod dry run: run every (architecture × input shape) step once on
one rank's shards of the production mesh, prove it fits, and extract
roofline terms (PyTorch counterpart of ``repro/launch/dryrun.py``).

It runs in its own process: it opens a FAKE process group (torch's
``fake`` backend: collectives return at once and move nothing) of 256
ranks, or 512 with ``--multi-pod``, builds the production mesh over it,
and runs ``launch/steps.py::build_case``'s step once as rank 0, on meta
tensors at rank 0's local shapes (no memory, no arithmetic), with the
collective counter of ``models/sharding.py`` reset before. The counter
sees every collective each time it is issued, so it needs none of the
reference's loop-trip corrections.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # single-pod sweep
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.

The record has the reference's keys: status, devices, meta, per_device
{analytic_flops, analytic_bytes, collective_bytes, collectives_by_type},
memory_analysis.argument_size_in_bytes (the exact bytes of rank 0's
argument slices), model_flops_global / _per_device, useful_flops_ratio,
roofline_terms_s (over the H100 constants of ``launch/mesh.py``; the
steps compute in bf16) and dominant_term. It omits the keys whose only
source is XLA: hlo_flops_raw, hlo_bytes_raw, collective_bytes_raw,
collective_bytes_flat_estimate, loop_trips, the other
memory_analysis sizes (temp_size_in_bytes, ...), lower_s and compile_s;
it adds step_s, the host seconds of the meta run. A step that cannot run
on meta tensors (one that needs a value on the host) is recorded FAILED
with its reason, as the reference records a failed compile; the exit
code is then 1.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import INPUT_SHAPES, get_config, list_configs
from repro_torch.launch import optflags
from repro_torch.launch.mesh import PEAK_FLOPS_BF16, make_production_mesh
from repro_torch.launch.roofline_model import (analytic_bytes,
                                               analytic_flops,
                                               roofline_terms)
from repro_torch.launch.steps import build_case, case_supported
from repro_torch.models.common import tree_leaves
from repro_torch.models.sharding import COUNTER, mesh_context


def model_flops(cfg, ishape) -> float:
    n_active = cfg.active_param_count()
    tokens = ishape.global_batch * (ishape.seq_len if ishape.mode != "decode"
                                    else 1)
    mult = 6.0 if ishape.mode == "train" else 2.0
    return mult * n_active * tokens


def argument_bytes(args) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(list(args))
               if isinstance(t, torch.Tensor))


def open_fake_group(world: int):
    """The default process group: ``world`` fake ranks, this one rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_case(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             q_block: int = 512, opt: str = "", mesh=None):
    from repro_torch.kernels.build import shape_only
    optflags.set_flags(opt.split(",") if opt else [])
    cfg = get_config(arch)
    ishape = INPUT_SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    if opt:
        tag += "__opt_" + opt.replace(",", "+").replace("=", "")
    ok, why = case_supported(cfg, ishape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "skipped", "skip_reason": why}
    if not ok:
        print(f"[dryrun] {tag}: SKIP ({why})")
        return rec

    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    t0 = time.time()
    try:
        grad = contextlib.nullcontext() if ishape.mode == "train" else \
            torch.no_grad()
        with mesh_context(mesh), shape_only(), grad:
            step, args, meta = build_case(cfg, ishape, mesh,
                                          q_block=q_block)
            arg_bytes = argument_bytes(args)
            COUNTER.reset()
            step(*args)
        t_step = time.time() - t0
    except Exception as e:  # noqa: BLE001 - record the failure
        rec.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {tag}: FAILED {type(e).__name__}: {e}")
        return rec

    per_type = dict(COUNTER.bytes)
    coll_total = COUNTER.total()
    flops_dev = analytic_flops(cfg, ishape) / n_dev
    bytes_dev = analytic_bytes(cfg, ishape, n_dev)
    mf = model_flops(cfg, ishape)
    terms = roofline_terms(flops_dev, bytes_dev, coll_total,
                           PEAK_FLOPS_BF16)
    dominant = max(terms, key=terms.get)
    meta = {k: list(v) if isinstance(v, tuple) else v
            for k, v in meta.items()}
    rec.update(
        status="ok", devices=n_dev, meta=meta, step_s=round(t_step, 1),
        per_device={"analytic_flops": flops_dev, "analytic_bytes": bytes_dev,
                    "collective_bytes": coll_total,
                    "collectives_by_type": per_type},
        memory_analysis={"argument_size_in_bytes": arg_bytes},
        model_flops_global=mf,
        model_flops_per_device=mf / n_dev,
        useful_flops_ratio=(mf / n_dev) / flops_dev if flops_dev else None,
        roofline_terms_s=terms,
        dominant_term=dominant,
    )
    print(f"[dryrun] {tag}: OK step={t_step:.1f}s "
          f"flops/dev={flops_dev:.3g} bytes/dev={bytes_dev:.3g} "
          f"coll/dev={coll_total:.3g} args={arg_bytes / 2 ** 30:.2f}GiB "
          f"dominant={dominant}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--q-block", type=int, default=512,
                    help="query-block size of the attention")
    ap.add_argument("--opt", default="",
                    help="comma-separated optflags (see launch/optflags.py)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ([args.arch] if args.arch else
             [a for a in list_configs() if not a.startswith("tiny-")])
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    open_fake_group(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    results = []
    for a in archs:
        for s in shapes:
            results.append(run_case(a, s, args.multi_pod, args.out,
                                    args.q_block, args.opt, mesh))
    bad = [r for r in results if r["status"] == "FAILED"]
    print(f"[dryrun] done: {len(results)} cases, "
          f"{sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, "
          f"{len(bad)} failed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
