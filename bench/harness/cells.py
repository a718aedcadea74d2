"""Everything of a cell, found by the names in ``BENCHMARK.json``: its
configuration file, its traffic mix (``bench/traffic/<traffic>.json``)
and one reader per metric (``bench/metrics/<metric>.py``, or the file of
the name before its first dot, which serves every suffix, e.g.
``decode_step_ms.py`` for ``decode_step_ms.steady``). Nothing here knows
a cell, a mix or a metric by name."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(metrics_dir: Path, name: str):
    """The ``read(run) -> float | None`` of metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = metrics_dir / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"bench_metric_{stem.replace('.', '_').replace('-', '_')}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{metrics_dir}")


def _reported(metric: dict, cell: str, e2e_here: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_here


def load(root: Path, bench_dir: Path, name: str) -> dict:
    """{"cell", "config", "conf", "mix", "end_to_end", "per_layer",
    "readers"} of the cell ``name``."""
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    here = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reported(m, name, here)]
    metrics_dir = bench_dir / "metrics"
    return {"cell": cell, "config": config,
            "conf": _read(root / config["file"]),
            "mix": _read(bench_dir / "traffic" / f"{cell['traffic']}.json"),
            "end_to_end": e2e, "per_layer": per_layer,
            "readers": {m["name"]: reader(metrics_dir, m["name"])
                        for m in e2e + per_layer}}
