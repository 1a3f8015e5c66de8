"""Finds a cell's pieces by name: its entry in ``BENCHMARK.json``, the
configuration, traffic mix and cell data files, and its metrics."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class CellSpec:
    name: str
    chips: int
    config: Dict           # configs/<config>.json
    mix: Dict              # traffic/<traffic>.json
    data: Dict             # cells/<cell>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]
    bench_dir: Path        # where the pieces live


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str, bench_dir: Path = HERE) -> CellSpec:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files
    read from ``bench_dir``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[workload]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return CellSpec(
        name=workload, chips=int(w["chips"]),
        config=load_json(bench_dir / "configs" / f"{w['config']}.json"),
        mix=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        data=load_json(bench_dir / "cells" / f"{workload}.json"),
        end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier
    (``layer_metrics/engine.prefill_ms.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(bench_dir: Path, metric: str):
    """The ``read(ctx)`` of ``layer_metrics/<metric>.py``."""
    path = bench_dir / "layer_metrics" / f"{metric}.py"
    return load_module(path, "perfbench_metric_" + metric.replace(".", "_")
                       .replace("-", "_")).read


def reference(bench_dir: Path, config: Dict):
    """The plain reference module a configuration names."""
    path = bench_dir / "reference" / f"{config['reference']}.py"
    return load_module(path, "perfbench_reference_" + config["reference"])
