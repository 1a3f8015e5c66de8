"""A configuration, a traffic mix, a cell and a per-layer metric dropped in
as new files (and entries in BENCHMARK.json) are found by name: no
existing file of the harness is edited."""
import json

from conftest import make_bench
from perfbench import spec
from perfbench.harness import run_cell

NEW_METRIC = '''
"""Engine calls per second of the window outside the traced part."""


def read(ctx):
    e = ctx.engine
    return e["decode_steps"] / max(e["decode_s"], 1e-9)
'''


def test_new_files_are_found(tmp_path):
    root = make_bench(tmp_path)
    bench = root / "perfbench"
    conf = json.loads((bench / "configs" / "granite-moe-3b-a800m.json").read_text())
    conf["name"] = "granite-shallow"
    conf["overrides"]["n_layers"] = 2
    conf["model"]["n_layers"] = 2
    (bench / "configs" / "granite-shallow.json").write_text(json.dumps(conf))
    # bursts: gaps of a gamma whose coefficient of variation is 3
    mix = {"loop": "open", "arrivals": {"dist": "gamma", "cv": 3.0},
           "prompt": {"dist": "uniform", "min": 8, "max": 48},
           "output": {"dist": "uniform", "min": 2, "max": 5}}
    (bench / "traffic" / "burst-test.json").write_text(json.dumps(mix))
    (bench / "cells" / "granite-shallow.burst-test.json").write_text(
        json.dumps({"n_slots": 3, "max_len": 56, "rate_per_s": 30.0,
                    "check_tokens": 10, "limits": {"logit_gap_mean": 1e-3}}))
    (bench / "layer_metrics" / "engine.steps_per_s.py").write_text(NEW_METRIC)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "granite-shallow.burst-test",
                           "config": "granite-shallow",
                           "traffic": "burst-test", "chips": 1, "why": "t"})
    b["per_layer"].append({"name": "engine.steps_per_s", "unit": "1/s",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine", "moves": "itl_p95_ms",
                           "workloads": ["granite-shallow.burst-test"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell(root, "granite-shallow.burst-test", bench)
    assert cell.config["name"] == "granite-shallow"
    assert [m["name"] for m in cell.per_layer] == ["engine.steps_per_s"]
    res = run_cell(cell, 123, 1.5, True, device="cpu")
    assert res["correct"], res["readings"]
    assert res["layer"]["engine.steps_per_s"] > 0
