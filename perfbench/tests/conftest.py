"""Fixtures of the harness's CPU tests: a copy of the benchmark whose
configurations are cut to a few layers of small width, in fp32 or
bf16, so a whole run takes seconds on the CPU."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

BENCH = ROOT / "perfbench"

TINY = {
    "granite-moe-3b-a800m": {"n_layers": 3, "d_model": 64, "n_heads": 6,
                             "kv_heads": 2, "head_dim": 16, "d_ff": 32,
                             "vocab": 300,
                             "moe": {"n_experts": 8, "top_k": 2,
                                     "expert_ff": 32}},
}

#: traffic cut to the tiny models' sizes, the same kinds of loop
TINY_MIX = {"docqa-poisson": {"prompt": {"min": 17, "max": 64,
                                         "median": 30},
                              "output": {"min": 3, "max": 6,
                                         "median": 4}},
            "chat-closed": {"prompt": {"min": 4, "max": 32, "median": 10},
                            "output": {"min": 4, "max": 12,
                                       "median": 8}}}


def tiny_config(name: str, dtype: str) -> dict:
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    over = dict(conf["overrides"], dtype=dtype, vocab_pad=64, remat="none",
                **TINY[name])
    conf["overrides"] = over
    model = conf["model"]
    for k, v in TINY[name].items():
        if isinstance(v, dict):
            model[k] = dict(model[k], **v)
        else:
            model[k] = v
    model["dtype"] = dtype
    return conf


def _workloads() -> list:
    """The cells of BENCHMARK.json, and those whose files are kept in the
    folder without an entry there (each named ``<config>.<traffic>``)."""
    listed = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
    names = {w["name"] for w in listed}
    kept = []
    for path in sorted((BENCH / "cells").glob("*.json")):
        if path.stem in names:
            continue
        for conf in (BENCH / "configs").glob("*.json"):
            traffic = path.stem[len(conf.stem) + 1:]
            if path.stem.startswith(conf.stem + ".") and \
                    (BENCH / "traffic" / f"{traffic}.json").exists():
                kept.append({"name": path.stem, "config": conf.stem,
                             "traffic": traffic, "chips": 1, "why": "kept"})
    return listed + kept


def tiny_cells() -> list:
    """The cells (listed or kept) whose configuration and mix have a tiny
    cut here."""
    return [w["name"] for w in _workloads()
            if w["config"] in TINY and w["traffic"] in TINY_MIX]


def make_bench(tmp: Path, dtype: str = "float32", limit: float = 1.0,
               rate: float = 40.0) -> Path:
    """A checkout-like tree under ``tmp``: BENCHMARK.json and a perfbench
    folder with tiny configurations, mixes and cells. Each cell keeps the
    kinds of reading its own file limits, each at ``limit``. Returns its
    root."""
    root = tmp / "root"
    bench = root / "perfbench"
    for sub in ("layer_metrics", "reference"):
        shutil.copytree(BENCH / sub, bench / sub)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [w for w in _workloads() if w["name"] in tiny_cells()]
    spec["configs"] = [c for c in spec["configs"] if c["name"] in TINY]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for sub in ("configs", "traffic", "cells"):
        (bench / sub).mkdir(parents=True)
    for c in spec["configs"]:
        (bench / "configs" / f"{c['name']}.json").write_text(
            json.dumps(tiny_config(c["name"], dtype)))
    for mix, cut in TINY_MIX.items():
        m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
        for k, v in cut.items():
            m[k] = dict(m[k], **v)
        (bench / "traffic" / f"{mix}.json").write_text(json.dumps(m))
    for w in spec["workloads"]:
        data = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        open_loop = w["traffic"] == "docqa-poisson"
        data.update(n_slots=4 if open_loop else 6,
                    max_len=64 + 6 if open_loop else 32 + 12,
                    check_tokens=20,
                    limits={k: limit for k in data["limits"]})
        if open_loop:
            data["rate_per_s"] = rate
        (bench / "cells" / f"{w['name']}.json").write_text(json.dumps(data))
    return root


@pytest.fixture(autouse=True)
def one_thread():
    """Runs here are timed windows: with the suite's workers sharing the
    cores, torch's own thread pool would starve them, so each test of
    the harness runs torch on one thread."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
