"""The port's joint autoscaler against the reference's, bit for bit.

Both packages' ``core/autoscale.py`` run on the CPU: the saturation
helpers on hand-made rows and on rows from a replica-bounded fleet run,
``AutoscaleSpec``'s validation messages, and ``ScaleSearcher`` (search
and resume) under each actuator set, each inner searcher and a finite
cluster with cold starts, compared field by field with floats by ``==``
(the wall clock left out). ``ScaleSearcher`` always replays with
replica pools, so it never sweeps on a device: it runs here with the
card reported absent. ``make_searcher("scale")`` resolves without an
explicit import, and the grid runner serializes a scale cell with the
reference's reason.
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (before repro.serverless: circular import)
from repro.core import autoscale as ref_autoscale
from repro.core import engine as ref_engine
from repro.core import resources as ref_resources
from repro.core import search as ref_search
from repro.serverless import generator as ref_gen
from repro.serverless import platform as ref_platform
from repro_torch.core import autoscale as port_autoscale
from repro_torch.core import engine as port_engine
from repro_torch.core import resources as port_resources
from repro_torch.core import search as port_search
from repro_torch.serverless import generator as port_gen
from repro_torch.serverless import platform as port_platform

from _torch_blas import one_blas_thread  # noqa: F401  (autouse)

REF = types.SimpleNamespace(autoscale=ref_autoscale, engine=ref_engine,
                            resources=ref_resources, search=ref_search,
                            gen=ref_gen, platform=ref_platform)
PORT = types.SimpleNamespace(autoscale=port_autoscale, engine=port_engine,
                             resources=port_resources, search=port_search,
                             gen=port_gen, platform=port_platform)
ROOT = Path(__file__).resolve().parents[1]


def _pooled_report(pkg, replicas):
    """A replica-bounded fleet of a 4-function chain on a finite cluster
    with cold starts: 24 Poisson arrivals, queueing behind the pools."""
    e = pkg.engine
    device = dict(device="cpu") if pkg is PORT else {}
    wf = pkg.gen.chain_workflow(4, seed=5, tenant="w")
    env = pkg.platform.SimulatedPlatform().environment()
    engine = e.FleetEngine(
        env.backend, pricing=env.pricing,
        cluster=e.ClusterModel(total_cpu=24.0, total_mem_mb=24576.0),
        cold_start=e.ColdStartModel(delay_s=0.5, keep_alive_s=30.0),
        scale=e.ReplicaModel(replicas={("w", n): r
                                       for n, r in replicas.items()},
                             provision_frac=0.25, provision_floor=0.02),
        **device)
    times = e.PoissonArrivals(0.4, 24, seed=3).times()
    return wf, engine.run([wf.copy() for _ in range(24)], times)


def test_saturation_helpers_equal_reference():
    views = []
    for pkg in (PORT, REF):
        a, r = pkg.autoscale, pkg.resources
        out = []
        replicas = {"f000": 1, "f001": 2, "f002": 1, "f003": 3}
        wf, report = _pooled_report(pkg, replicas)
        sat = report.saturation()
        cold = float(sum(report.cold_delays.tolist()))
        out.append(a.classify_saturation(sat, cold))
        out.append(a.classify_saturation(sat, 0.0))
        out.append(a.classify_saturation({}, 0.0))
        hand = {"a/f": {"queue_delay_s": 3.0}, "a/g": {"queue_delay_s": 1.0},
                "b/f": {"queue_delay_s": 0.25}}
        out.append(a.classify_saturation(hand, 4.0))
        cp = ["f000", "f001", "f002", "f003"]
        for width, cap in ((1, 8), (3, 2), (6, 3), (2, 1)):
            out.append(a.grant_replicas(replicas, sat, cp, width=width,
                                        max_replicas=cap))
            out.append(a.grant_replicas({"f": 1, "g": 1, "h": 1}, hand,
                                        ["g"], width=width,
                                        max_replicas=cap))
        configs = {n: r.ResourceConfig(cpu=1.0 + i, mem=512.0 * (i + 1))
                   for i, n in enumerate(cp)}
        for base in (pkg.engine.ClusterModel(total_cpu=6.0,
                                             total_mem_mb=4096.0),
                     pkg.engine.ClusterModel(total_cpu=100.0,
                                             total_mem_mb=1e6),
                     pkg.engine.INFINITE_CLUSTER):
            for max_scale, floor in ((8.0, 1.0), (1.5, 1.0), (8.0, 3.0)):
                out.append(a.pool_capacity_factor(
                    replicas, configs, base, max_scale=max_scale,
                    floor=floor))
        out.append(sorted(sat.items()))
        views.append(out)
    assert views[0] == views[1]
    port = views[0]
    assert port[0][0] and 0.0 < port[0][1] < 1.0   # queue and cold delay


@pytest.mark.parametrize("kw", [
    dict(actuators=("config", "warp")), dict(actuators=()),
    dict(max_replicas=0), dict(grant_width=0), dict(max_cluster_scale=0.5),
    dict(queue_share_threshold=1.5), dict(deploy_utilization=0.0)])
def test_spec_errors_equal_reference(kw):
    with pytest.raises(ValueError) as port_err:
        port_autoscale.AutoscaleSpec(**kw)
    with pytest.raises(ValueError) as ref_err:
        ref_autoscale.AutoscaleSpec(**kw)
    assert str(port_err.value) == str(ref_err.value)


def _view(res):
    """A scale result as plain values: the summary but the wall clock,
    the configurations, the joint action and the trace sample by
    sample."""
    summary = res.summary()
    summary.pop("wall_time_s", None)
    return (summary, sorted((n, c.cpu, c.mem) for n, c in res.configs.items()),
            sorted(res.replicas.items()), res.cluster_scale,
            res.fleet_attainment, res.fleet_cost, res.fleet_evals, res.note,
            res.n_samples, res.search_time, res.search_cost,
            [dataclasses.astuple(s) for s in res.trace.samples],
            res.state.payload)


#: the reference test's standalone search context, and the variants
SEARCH = dict(rate=0.05, n_instances=12, max_rounds=4, config_grant=4,
              max_replicas=4, provision_frac=0.0)
CASES = {
    "joint": ({}, "aarc", None),
    "config_only": (dict(actuators=("config",)), "aarc", None),
    "scale_only": (dict(actuators=("scale",)), "aarc", None),
    "maff": ({}, "maff", None),
    "bo": ({}, "bo", {"n_rounds": 6, "batch_size": 2}),
    "finite_cold": (dict(rate=0.2, n_instances=16, provision_floor=0.02,
                         max_rounds=6), "aarc", "finite"),
}


def _searcher(pkg, case):
    extra, inner, flag = CASES[case]
    kw = dict(SEARCH, **extra)
    inner_kwargs = None
    if flag == "finite":
        kw["cluster"] = pkg.engine.ClusterModel(total_cpu=12.0,
                                                total_mem_mb=12288.0)
        kw["cold_start"] = pkg.engine.ColdStartModel(delay_s=0.5,
                                                     keep_alive_s=20.0)
    elif flag is not None:
        inner_kwargs = flag
    env = pkg.platform.SimulatedPlatform().environment()
    return pkg.search.make_searcher(
        "scale", env, inner=inner, spec=pkg.autoscale.AutoscaleSpec(**kw),
        inner_kwargs=inner_kwargs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scale_search_and_resume_equal_reference(case, monkeypatch):
    """``search`` then ``resume`` with 4 more samples; no card needed."""
    views = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        if pkg is PORT:
            monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        searcher = _searcher(pkg, case)
        wf = pkg.gen.chain_workflow(3, seed=2)
        res = searcher.search(wf, 120.0)
        first = _view(res)
        assert searcher.resume(res.state, 0) is res
        try:
            resumed = _view(searcher.resume(res.state, 4))
        except AttributeError as err:
            # the resume hands BO no payload, in the reference too
            resumed = (type(err).__name__, str(err))
        views[name] = (first, resumed)
    assert views["port"] == views["ref"]
    summary = views["port"][0][0]
    assert summary["fleet_evals"] >= 1
    assert (views["port"][1][0] == "AttributeError") == (case == "bo")
    if case in ("joint", "scale_only"):
        # ~1.85 erlangs offered per one-replica pool: the loop scales out
        assert summary["total_replicas"] > 3


def test_scale_searcher_never_sweeps(monkeypatch):
    sweeps = []
    monkeypatch.setattr(port_engine, "fast_plane_sweep",
                        lambda *a, **k: sweeps.append(k))
    searcher = _searcher(PORT, "joint")
    searcher.search(port_gen.chain_workflow(3, seed=2), 120.0)
    assert sweeps == []


_MAKE_SCALE = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
from repro_torch.core.search import SEARCHERS, make_searcher
from repro_torch.serverless.platform import SimulatedPlatform

env = SimulatedPlatform().environment()
first = make_searcher("scale", env)
# the lazy branch: an unregistered "scale" is imported on demand
del SEARCHERS["scale"]
del sys.modules["repro_torch.core.autoscale"]
again = make_searcher("scale", env, inner="maff")
print(type(first).__name__, type(again).__module__, again.inner_name,
      "scale" in SEARCHERS)
"""


def test_make_searcher_scale_in_a_fresh_interpreter():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _MAKE_SCALE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ScaleSearcher",
                                  "repro_torch.core.autoscale", "maff",
                                  "True"]
    errors = []
    for pkg in (PORT, REF):
        env_ = pkg.platform.SimulatedPlatform().environment()
        with pytest.raises(ValueError) as err:
            pkg.search.make_searcher("scale", env_, inner="scale")
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_grid_serializes_a_scale_cell_with_the_reference_reason():
    views = []
    for pkg in (PORT, REF):
        spec = pkg.autoscale.AutoscaleSpec(**SEARCH)
        cells = [(pkg.search.make_searcher(
                      "scale", pkg.platform.SimulatedPlatform().environment(),
                      spec=spec), pkg.gen.chain_workflow(3, seed=2), 120.0),
                 (pkg.search.make_searcher(
                      "aarc", pkg.platform.SimulatedPlatform().environment),
                  pkg.gen.chain_workflow(4, seed=3), 90.0)]
        report = pkg.search.run_grid_search(cells)
        views.append((
            [(e.index, e.searcher, e.workflow, e.eligible, e.fusable,
              e.reasons) for e in report.eligibility],
            report.serialized_cells, _view(report.results[0]),
            [dataclasses.astuple(s)
             for s in report.results[1].trace.samples]))
    assert views[0] == views[1]
    eligibility = views[0][0]
    assert not eligibility[0][3] and eligibility[1][3]
    assert any("no plan()" in r for r in eligibility[0][5])
    assert views[0][1] == 1
