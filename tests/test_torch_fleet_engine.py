"""The port's fleet engine against the reference's, bit for bit.

``repro_torch.core.engine.FleetEngine`` is a numpy copy of the reference's
engine whose contention-free plane sweeps with torch (``plane_backend=
"torch"``, run here with ``device="cpu"``). The same generated templates,
candidate configurations and arrivals go through both packages: every
report of ``run`` and of ``run_many`` on each of the four replay planes
(fast, constrained, planned, serial) must equal the reference's numpy
plane field by field, with ``==`` (NaN equal to NaN), through
``saturation()``, ``by_tenant()`` and the carry.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (before repro.serverless: circular import)
from repro.core import backend as ref_backend
from repro.core import cost as ref_cost
from repro.core import engine as ref_engine
from repro.core import resources as ref_resources
from repro.serverless import generator as ref_generator
from repro.serverless import platform as ref_platform
from repro.serverless import workloads as ref_workloads
from repro_torch.core import backend as port_backend
from repro_torch.core import cost as port_cost
from repro_torch.core import engine as port_engine
from repro_torch.core import resources as port_resources
from repro_torch.serverless import generator as port_generator
from repro_torch.serverless import platform as port_platform
from repro_torch.serverless import workloads as port_workloads

from _torch_fleet_parity import (assert_same, assert_same_report,
                                 assert_same_reports, node_states)

REF = types.SimpleNamespace(
    engine=ref_engine, backend=ref_backend,
    Config=ref_resources.ResourceConfig, gen=ref_generator,
    platform=ref_platform, workloads=ref_workloads)
PORT = types.SimpleNamespace(
    engine=port_engine, backend=port_backend,
    Config=port_resources.ResourceConfig, gen=port_generator,
    platform=port_platform, workloads=port_workloads)

TOPOLOGIES = {
    "chain": lambda g: g.chain_workflow(5, seed=11),
    "fan": lambda g: g.fan_workflow(4, seed=12),
    "diamond": lambda g: g.diamond_workflow(2, seed=13),
    "layered": lambda g: g.layered_workflow(10, n_layers=3, seed=14),
}
SLOS = (20.0, 60.0, 200.0)
#: the port's planes, each held to the reference's numpy plane
PORT_PLANES = [dict(plane_backend="torch", device="cpu"),
               dict(plane_backend="numpy")]


def cluster(pkg, finite):
    return (pkg.engine.ClusterModel(total_cpu=12.0, total_mem_mb=16384.0)
            if finite else pkg.engine.INFINITE_CLUSTER)


def cold(pkg, on):
    return (pkg.engine.ColdStartModel(delay_s=1.0, keep_alive_s=30.0)
            if on else pkg.engine.NO_COLD_START)


def make_engine(pkg, *, backend=None, pricing=None, **kw):
    plat = pkg.platform.SimulatedPlatform()
    return pkg.engine.FleetEngine(backend or plat.backend,
                                  pricing=pricing or plat.pricing, **kw)


def candidate_sets(pkg, template, n_cand, seed=0):
    rng = np.random.default_rng(seed)
    return [{n.name: pkg.Config(cpu=float(rng.uniform(1.0, 8.0)),
                                mem=float(rng.uniform(1024.0, 8192.0)))
             for n in template} for _ in range(n_cand)]


def arrival_sets(n_seeds, n=6, rate=0.25, start=0.0):
    return [ref_engine.PoissonArrivals(rate, n, seed=s, start=start).times()
            for s in range(n_seeds)]


def fleet(template, configs, n):
    wfs = []
    for _ in range(n):
        wf = template.copy()
        wf.apply_configs(configs)
        wfs.append(wf)
    return wfs


def carry(pkg, template, busy=((700.0, 2.0, 512.0),)):
    """A carried-in epoch: one warm container per function, and capacity
    reservations still running."""
    warm = {(template.identity, name): [[0.0, 40.0]]
            for name in list(template.nodes)[:2]}
    return pkg.engine.FleetCarry(clock=0.0, warm=warm, busy=list(busy))


@pytest.mark.parametrize("cold_on", [False, True], ids=["warm", "cold"])
@pytest.mark.parametrize("finite", [False, True], ids=["infinite", "finite"])
@pytest.mark.parametrize("kind", list(TOPOLOGIES))
def test_run_many_equals_reference(kind, finite, cold_on):
    """Fast plane (infinite, warm) and constrained plane (finite or cold):
    the port's torch and numpy planes against the reference's numpy plane,
    and the routing diagnostic against the reference's."""
    want_t = TOPOLOGIES[kind](REF.gen)
    got_t = TOPOLOGIES[kind](PORT.gen)
    seeds = arrival_sets(2)
    want_eng = make_engine(REF, cluster=cluster(REF, finite),
                           cold_start=cold(REF, cold_on))
    want = want_eng.run_many(want_t, candidate_sets(REF, want_t, 3, 16),
                             seeds)
    plane = "constrained" if finite or cold_on else "fast"
    for kw in PORT_PLANES:
        eng = make_engine(PORT, cluster=cluster(PORT, finite),
                          cold_start=cold(PORT, cold_on), **kw)
        cands = candidate_sets(PORT, got_t, 3, 16)
        elig = eng.batch_eligibility(got_t, cands, probe_candidates=True)
        assert elig["plane"] == plane
        assert_same(elig, want_eng.batch_eligibility(
            want_t, candidate_sets(REF, want_t, 3, 16),
            probe_candidates=True))
        assert_same_reports(eng.run_many(got_t, cands, seeds), want, SLOS)


@pytest.mark.parametrize("cold_on", [False, True], ids=["warm", "cold"])
@pytest.mark.parametrize("finite", [False, True], ids=["infinite", "finite"])
@pytest.mark.parametrize("kind", list(TOPOLOGIES))
def test_run_equals_reference(kind, finite, cold_on):
    """The scalar event loop: one fleet of copies, its report and the
    runtimes written onto every copy."""
    times = arrival_sets(1, n=8, rate=0.5)[0]
    out = []
    for pkg in (PORT, REF):
        template = TOPOLOGIES[kind](pkg.gen)
        wfs = fleet(template, candidate_sets(pkg, template, 1, 3)[0], 8)
        eng = make_engine(pkg, cluster=cluster(pkg, finite),
                          cold_start=cold(pkg, cold_on))
        out.append((eng.run(wfs, times), [node_states(wf) for wf in wfs]))
    assert_same_report(out[0][0], out[1][0], SLOS)
    assert out[0][1] == out[1][1]


class _RefMirrorPricing(ref_cost.PricingModel):
    """The same prices through a scalar override with no matching
    ``cost_batch``: routes ``run_many`` onto the planned plane."""

    def function_cost(self, runtime_s, config):
        return super().function_cost(runtime_s, config)


class _PortMirrorPricing(port_cost.PricingModel):
    def function_cost(self, runtime_s, config):
        return super().function_cost(runtime_s, config)


def opaque_backend(pkg):
    """A bare oracle: not ``batch_safe``, so ``run_many`` serializes."""
    surface = pkg.platform.AnalyticBackend()
    return pkg.backend.CallableBackend(surface.invoke, surface.invoke_clamped)


PLANES = {
    "planned": lambda pkg: dict(pricing=(_PortMirrorPricing() if pkg is PORT
                                         else _RefMirrorPricing())),
    "serial": lambda pkg: dict(backend=opaque_backend(pkg)),
}


@pytest.mark.parametrize("finite", [False, True], ids=["infinite", "finite"])
@pytest.mark.parametrize("plane", list(PLANES))
@pytest.mark.parametrize("kind", list(TOPOLOGIES))
def test_planned_and_serial_planes_equal_reference(kind, plane, finite):
    reports, eligs = [], []
    for pkg in (PORT, REF):
        template = TOPOLOGIES[kind](pkg.gen)
        eng = make_engine(pkg, cluster=cluster(pkg, finite),
                          **PLANES[plane](pkg))
        cands = candidate_sets(pkg, template, 2, 5)
        eligs.append(eng.batch_eligibility(template, cands))
        reports.append(eng.run_many(template, cands, arrival_sets(2)))
    assert eligs[0]["plane"] == plane
    assert_same(eligs[0], eligs[1])
    assert_same_reports(reports[0], reports[1], SLOS)


class _RefNoClamp(ref_platform.AnalyticBackend):
    """Unbounded failures (+inf): a dead instance never runs downstream."""
    has_clamped = False

    def _surface(self, cpu, mem, spec_arrays):
        rt, failed = super()._surface(cpu, mem, spec_arrays)
        return np.where(failed, np.inf, rt), failed


class _PortNoClamp(port_platform.AnalyticBackend):
    has_clamped = False

    def _surface(self, cpu, mem, spec_arrays):
        rt, failed = super()._surface(cpu, mem, spec_arrays)
        return np.where(failed, np.inf, rt), failed


@pytest.mark.parametrize("finite", [False, True], ids=["infinite", "finite"])
def test_unbounded_failures_and_single_instance_cells_equal_reference(finite):
    """A candidate below its working sets dies at +inf (per-cell replay off
    the plan), a healthy one sweeps, and a one-instance arrival set takes
    the degenerate path's association."""
    reports = []
    for pkg, backend in ((PORT, _PortNoClamp()), (REF, _RefNoClamp())):
        template = pkg.gen.diamond_workflow(2, seed=13)
        healthy = {n.name: pkg.Config(cpu=4.0, mem=8192.0) for n in template}
        dying = {n.name: pkg.Config(cpu=4.0, mem=128.0) for n in template}
        kw = dict(device="cpu") if pkg is PORT else {}
        eng = make_engine(pkg, backend=backend, cluster=cluster(pkg, finite),
                          **kw)
        reports.append(eng.run_many(template, [healthy, dying, healthy],
                                    arrival_sets(2) + [np.array([3.0])]))
    assert math.isinf(reports[0][3].p99)
    assert_same_reports(reports[0], reports[1], SLOS)


@pytest.mark.parametrize("kw", [
    dict(cluster=True), dict(cold=True), dict()],
    ids=["finite", "cold", "infinite"])
def test_carry_in_and_out_equals_reference(kw):
    """A carried-in backlog and warm pool, ``collect_carry`` out, and the
    pruned carry fed to the next epoch: ``run`` and ``run_many``."""
    out = []
    for pkg in (PORT, REF):
        template = pkg.gen.fan_workflow(4, seed=12)
        extra = dict(device="cpu") if pkg is PORT else {}
        eng = make_engine(pkg, cluster=cluster(pkg, kw.get("cluster", False)),
                          cold_start=cold(pkg, kw.get("cold", False)), **extra)
        cands = candidate_sets(pkg, template, 2, 7)
        c_in = carry(pkg, template)
        many = eng.run_many(template, cands, arrival_sets(2), carry=c_in,
                            collect_carry=True)
        first = eng.run(fleet(template, cands[0], 6), arrival_sets(1)[0],
                        carry=c_in, collect_carry=True)
        nxt = first.carry.pruned(30.0)
        second = eng.run(fleet(template, cands[1], 6),
                         arrival_sets(1, start=30.0)[0], carry=nxt,
                         collect_carry=True)
        busy_only = eng.run_many(template, cands, arrival_sets(2),
                                 carry=carry(pkg, template))
        out.append((many, first, nxt, second, busy_only))
    got, want = out
    assert_same_reports(got[0], want[0], SLOS)
    assert_same_report(got[1], want[1], SLOS)
    assert_same(got[2], want[2], "pruned carry")
    assert_same_report(got[3], want[3], SLOS)
    assert_same_reports(got[4], want[4], SLOS)


def test_replicas_interference_and_tenants_equal_reference():
    """Replica pools (billed), interference multipliers and a packed
    two-tenant fleet: ``run`` and ``run_many``, ``by_tenant()`` and the
    provisioning ledgers."""
    out = []
    for pkg in (PORT, REF):
        a = pkg.gen.layered_workflow(8, n_layers=3, seed=3, tenant="t-a")
        b = pkg.gen.chain_workflow(4, seed=4, tenant="t-b")
        names_a, names_b = list(a.nodes), list(b.nodes)
        scale = pkg.engine.ReplicaModel(
            replicas={names_a[0]: 2, ("t-b", names_b[1]): 3}, default=1,
            provision_frac=0.25, provision_floor=0.001)
        interference = {("t-a", names_a[1]): 1.5, ("t-b", names_b[0]): 1.25}
        eng = make_engine(pkg, cluster=cluster(pkg, True),
                          cold_start=cold(pkg, True), scale=scale,
                          interference=interference)
        wfs = fleet(a, {}, 5) + fleet(b, {}, 5)
        times = arrival_sets(1, n=10, rate=0.5)[0]
        mixed = eng.run(wfs, times, collect_carry=True)
        scaled = make_engine(pkg, cluster=cluster(pkg, True), scale=scale)
        elig = scaled.batch_eligibility(a, candidate_sets(pkg, a, 2, 9))
        many = scaled.run_many(a, candidate_sets(pkg, a, 2, 9),
                               arrival_sets(2))
        noisy = make_engine(pkg, interference=interference)
        serial = noisy.run_many(b, candidate_sets(pkg, b, 2, 9),
                                arrival_sets(2))
        out.append((mixed, elig, many, serial,
                    [node_states(wf) for wf in wfs]))
    got, want = out
    assert sorted(got[0].by_tenant()) == ["t-a", "t-b"]
    assert got[0].provision_by_function
    assert_same_report(got[0], want[0], SLOS)
    assert_same(got[1], want[1])
    assert_same_reports(got[2], want[2], SLOS)
    assert_same_reports(got[3], want[3], SLOS)
    assert got[4] == want[4]


def test_empty_fleets_and_unknown_names_equal_reference():
    out = []
    for pkg in (PORT, REF):
        template = pkg.gen.chain_workflow(3, seed=1)
        eng = make_engine(pkg, **({"device": "cpu"} if pkg is PORT else {}))
        cands = candidate_sets(pkg, template, 2)
        out.append((
            eng.run([], []),
            eng.run([], [], carry=carry(pkg, template), collect_carry=True),
            eng.run_many(template, cands, [np.empty(0), arrival_sets(1)[0]]),
            eng.run_many(template, [], arrival_sets(1)),
            eng.run_many(template, cands, []),
            eng.run_many(pkg.engine.Workflow("empty"), [{}],
                         arrival_sets(1))))
        with pytest.raises(KeyError):
            eng.run_many(template, [{"nope": pkg.Config(cpu=1.0, mem=512.0)}],
                         arrival_sets(1))
    got, want = out
    for i in (0, 1):
        assert_same_report(got[i], want[i], SLOS)
    for i in (2, 5):
        assert_same_reports(got[i], want[i], SLOS)
    assert got[3] == want[3] == [] and got[4] == want[4] == []


def error_message(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_error_surfaces_carry_the_reference_messages():
    msgs = []
    for pkg in (PORT, REF):
        template = pkg.gen.fan_workflow(3, seed=2)
        big = {n: pkg.Config(cpu=8.0, mem=8192.0) for n in template.nodes}
        small = make_engine(pkg, cluster=pkg.engine.ClusterModel(
            total_cpu=4.0, total_mem_mb=65536.0))
        eng = make_engine(pkg)
        msgs.append([
            error_message(lambda: small.run(fleet(template, big, 2),
                                            [0.0, 1.0])),
            error_message(lambda: small.run_many(template, [big],
                                                 arrival_sets(1))),
            error_message(lambda: eng.run(fleet(template, {}, 3),
                                          [0.0, 1.0])),
            error_message(lambda: pkg.engine.run_fleet(
                pkg.platform.make_env(), template, [0.0, 1.0], copy=False)),
            error_message(lambda: pkg.engine.PoissonArrivals(0.0, 3)),
            error_message(lambda: pkg.engine.ReplicaModel(replicas={"a": 0})),
            error_message(lambda: pkg.engine.FleetEngine(
                pkg.platform.AnalyticBackend(),
                interference={("x", "y"): 0.0})),
        ])
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError) as exc:
        port_engine.FleetEngine(port_platform.AnalyticBackend(),
                                plane_backend="jax")
    assert str(exc.value) == \
        "plane_backend must be 'numpy' or 'torch', got 'jax'"


@pytest.mark.parametrize("finite", [False, True], ids=["infinite", "finite"])
def test_run_fleet_equals_reference(finite):
    """``run_fleet`` over the paper's Chatbot workflow, a template copied
    per instance and a factory fleet."""
    out = []
    for pkg in (PORT, REF):
        env = pkg.platform.make_env()
        wf = pkg.workloads.chatbot()
        arrivals = pkg.engine.PoissonArrivals(rate=0.2, n=30, seed=7)
        kw = dict(cluster=cluster(pkg, finite), cold_start=cold(pkg, finite))
        out.append((pkg.engine.run_fleet(env, wf, arrivals, **kw),
                    pkg.engine.run_fleet(
                        env, lambda i: pkg.workloads.chatbot(),
                        pkg.engine.TraceArrivals(arrivals.times()[::-1]),
                        **kw)))
    for got, want in zip(*out):
        assert_same_report(got, want, SLOS)


def test_default_engine_needs_the_card_only_to_sweep(monkeypatch):
    """Without a card, a default engine (``device=None``) still runs the
    degenerate path, the event loop and ``Environment.execute``; only a
    fast-plane sweep raises, and it does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    template = port_generator.layered_workflow(6, n_layers=2, seed=5)
    eng = make_engine(PORT)
    assert eng.plane_backend == "torch" and eng.device is None
    one = eng.run([template.copy()], [0.0])
    many = eng.run(fleet(template, {}, 4), [0.0, 1.0, 2.0, 3.0])
    env = port_platform.make_env()
    sample = env.execute(template.copy(), slo=1e9)
    assert len(one) == 1 and len(many) == 4 and sample.feasible
    constrained = make_engine(PORT, cluster=cluster(PORT, True))
    assert len(constrained.run_many(template, [{}], arrival_sets(1))) == 1
    assert eng.batch_eligibility(template, [{}])["plane"] == "fast"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eng.run_many(template, [{}], arrival_sets(1))
    numpy_plane = make_engine(PORT, plane_backend="numpy")
    assert len(numpy_plane.run_many(template, [{}], arrival_sets(1))) == 1


def test_environment_runs_through_the_engine():
    """``Environment.execute`` is the engine's degenerate case: the same
    samples as the reference's, through one cached engine, and the batch
    entry points copied beside it."""
    envs = [PORT.platform.make_env(), REF.platform.make_env()]
    assert isinstance(envs[0].engine, port_engine.FleetEngine)
    assert envs[0].engine is envs[0].engine
    out = []
    for pkg, env in zip((PORT, REF), envs):
        wfs = [pkg.gen.generate(kind, seed=s)
               for s, kind in enumerate(("chain", "fan", "diamond"))]
        wfs[1].apply_configs({n: pkg.Config(cpu=1.0, mem=128.0)
                              for n in list(wfs[1].nodes)[:1]})
        env.execute(wfs[0], slo=100.0)
        env.execute_batch(wfs, slo=[50.0, 100.0, 150.0])
        nodes = list(wfs[2])[:3]
        for node in nodes:
            node.config = pkg.Config(cpu=2.0, mem=2048.0)
        env.execute_function_batch(wfs[2], nodes, slo=100.0)
        out.append(([tuple(vars(s).values()) for s in env.trace.samples],
                    [node_states(wf) for wf in wfs]))
    assert out[0] == out[1]
