"""The port's fault injection and recovery against the reference's.

``FaultModel`` draws one seeded uniform tensor per replay plane; the
engine's ``_FaultCtx`` resolves every admitted attempt from it (transient
failures, stragglers, cold-start failures, outages) under the
``ResilienceModel``'s retries, timeouts and hedges. The same fault models,
policies, templates and arrivals go through both packages: the streams,
the policy ladder, ``run`` and ``run_many`` on every plane that takes
faults, and ``ResilienceSearcher``'s results must be equal, floats
compared with ``==``.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (before repro.serverless: circular import)
from repro.core import backend as ref_backend
from repro.core import cost as ref_cost
from repro.core import engine as ref_engine
from repro.core import faults as ref_faults
from repro.core import resources as ref_resources
from repro.core import search as ref_search
from repro.serverless import generator as ref_generator
from repro.serverless import platform as ref_platform
from repro_torch.core import backend as port_backend
from repro_torch.core import cost as port_cost
from repro_torch.core import engine as port_engine
from repro_torch.core import faults as port_faults
from repro_torch.core import resources as port_resources
from repro_torch.core import search as port_search
from repro_torch.serverless import generator as port_generator
from repro_torch.serverless import platform as port_platform

from _torch_fleet_parity import (assert_same, assert_same_report,
                                 assert_same_reports, node_states)

REF = types.SimpleNamespace(
    engine=ref_engine, faults=ref_faults, backend=ref_backend,
    Config=ref_resources.ResourceConfig, gen=ref_generator,
    platform=ref_platform, search=ref_search)
PORT = types.SimpleNamespace(
    engine=port_engine, faults=port_faults, backend=port_backend,
    Config=port_resources.ResourceConfig, gen=port_generator,
    platform=port_platform, search=port_search)
SLOS = (30.0, 90.0)


def fault_model(pkg, **kw):
    base = dict(default_transient=0.25, straggler_prob=0.15,
                straggler_factor=5.0, cold_fail=0.2, seed=3)
    base.update(kw)
    return pkg.faults.FaultModel(**base)


def policies(pkg, kind):
    """No recovery, retries, a straggler timeout, hedging, and a
    per-function mix of all three."""
    P = pkg.faults.ResiliencePolicy
    return {
        "none": None,
        "retries": pkg.faults.ResilienceModel(
            default=P(max_retries=2, backoff_s=0.05)),
        "timeout": pkg.faults.ResilienceModel(
            default=P(max_retries=3, timeout_s=15.0, backoff_s=0.1)),
        "hedge": pkg.faults.ResilienceModel(default=P(hedge_delay_s=6.0)),
        "mixed": pkg.faults.ResilienceModel(
            policies={"f0001": P(max_retries=1, timeout_s=20.0,
                                 hedge_delay_s=4.0),
                      ("t-a", "f0002"): P(max_retries=4, backoff_s=0.2)},
            default=P(max_retries=1)),
    }[kind]


class _RefMirrorPricing(ref_cost.PricingModel):
    def function_cost(self, runtime_s, config):
        return super().function_cost(runtime_s, config)


class _PortMirrorPricing(port_cost.PricingModel):
    def function_cost(self, runtime_s, config):
        return super().function_cost(runtime_s, config)


def opaque_backend(pkg):
    surface = pkg.platform.AnalyticBackend()
    return pkg.backend.CallableBackend(surface.invoke, surface.invoke_clamped)


#: the planes that take faults (the fast plane routes them to constrained)
PLANES = {
    "constrained": lambda pkg: {},
    "constrained-finite": lambda pkg: dict(
        cluster=pkg.engine.ClusterModel(total_cpu=24.0, total_mem_mb=24576.0),
        cold_start=pkg.engine.ColdStartModel(delay_s=0.25,
                                             keep_alive_s=60.0)),
    "planned": lambda pkg: dict(pricing=(_PortMirrorPricing() if pkg is PORT
                                         else _RefMirrorPricing())),
    "serial": lambda pkg: dict(backend=opaque_backend(pkg)),
    "stochastic": lambda pkg: dict(backend=pkg.platform.StochasticBackend(
        noise_sigma=0.05, seed=8)),
}


def make_engine(pkg, *, backend=None, pricing=None, **kw):
    plat = pkg.platform.SimulatedPlatform()
    return pkg.engine.FleetEngine(backend or plat.backend,
                                  pricing=pricing or plat.pricing, **kw)


def candidate_sets(pkg, template, n_cand, seed=0):
    rng = np.random.default_rng(seed)
    return [{n.name: pkg.Config(cpu=float(rng.uniform(1.0, 8.0)),
                                mem=float(rng.uniform(1024.0, 8192.0)))
             for n in template} for _ in range(n_cand)]


def arrival_sets(n_seeds, n=8, rate=0.25):
    return [ref_engine.PoissonArrivals(rate, n, seed=s).times()
            for s in range(n_seeds)]


def test_fault_streams_and_key_resolution_equal_reference():
    out = []
    for pkg in (PORT, REF):
        F = pkg.faults
        window = F.OutageWindow(node=0, start_s=5.0, end_s=40.0)
        fm = F.FaultModel(transient={("t1", "f"): 0.5, "f": 0.25},
                          default_transient=0.05, outages=(window,),
                          node_of={"t1": 0, ("t2", "g"): 0, "t3": 1},
                          outage_fail=0.9, seed=7)
        stream = fm.fault_stream(12, 4)
        pol = F.ResiliencePolicy(max_retries=2, timeout_s=3.0)
        rm = F.ResilienceModel(policies={("t1", "f"): pol, "g": F.NO_RECOVERY},
                               default=F.ResiliencePolicy(max_retries=1))
        rows = [stream.primary, stream.hedge, stream.max_attempts,
                F.MAX_ATTEMPTS]
        for ident, name in (("t1", "f"), ("t2", "f"), ("t2", "g"),
                            ("t3", "h"), ("t4", "h")):
            rows.append((fm.rate(ident, name), fm.node_for(ident, name),
                         [(fm.outage_active(ident, name, t),
                           fm.effective_transient(ident, name, t))
                          for t in (0.0, 5.0, 39.9, 40.0)],
                         dataclasses.astuple(rm.policy(ident, name))))
        out.append(rows)
    assert_same(out[0], out[1])


def error(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_invalid_knobs_carry_the_reference_messages():
    msgs = []
    for pkg in (PORT, REF):
        F = pkg.faults
        msgs.append([
            error(lambda: F.FaultModel(default_transient=1.5)),
            error(lambda: F.FaultModel(transient={"f": -0.1})),
            error(lambda: F.FaultModel(straggler_factor=0.5)),
            error(lambda: F.OutageWindow(node=0, start_s=5.0, end_s=5.0)),
            error(lambda: F.OutageWindow(node=-1, start_s=0.0, end_s=5.0)),
            error(lambda: F.ResiliencePolicy(max_retries=8)),
            error(lambda: F.ResiliencePolicy(timeout_s=0.0)),
            error(lambda: F.ResiliencePolicy(backoff_s=-1.0)),
            error(lambda: F.ResiliencePolicy(hedge_delay_s=-1.0)),
            error(lambda: F.ResilienceSpec(max_retries=0)),
            error(lambda: F.ResilienceSpec(grant_width=0)),
            error(lambda: F.ResilienceSpec(retune_step=0.0)),
            error(lambda: F.ResilienceSearcher(
                pkg.platform.make_env, inner="resilience")),
        ])
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kind", ["none", "retries", "timeout", "hedge",
                                  "mixed"])
@pytest.mark.parametrize("plane", list(PLANES))
def test_faulty_run_many_and_run_equal_reference(plane, kind):
    """``run_many`` under faults on each plane that takes them, and the
    scalar ``run`` of one of its cells, against the reference's."""
    out = []
    for pkg in (PORT, REF):
        template = pkg.gen.layered_workflow(8, n_layers=3, seed=21,
                                            tenant="t-a")
        eng = make_engine(pkg, faults=fault_model(pkg),
                          resilience=policies(pkg, kind),
                          **PLANES[plane](pkg))
        cands = candidate_sets(pkg, template, 2, 4)
        elig = eng.batch_eligibility(template, cands)
        many = eng.run_many(template, cands + cands[:1], arrival_sets(2))
        wfs = []
        for _ in range(8):
            wf = template.copy()
            wf.apply_configs(cands[1])
            wfs.append(wf)
        one = eng.run(wfs, arrival_sets(1)[0])
        out.append((elig, many, one, [node_states(wf) for wf in wfs]))
    got, want = out
    assert got[0]["plane"] == plane.split("-")[0].replace("stochastic",
                                                          "constrained")
    assert_same(got[0], want[0])
    assert_same_reports(got[1], want[1], SLOS)
    assert_same_report(got[2], want[2], SLOS)
    assert got[3] == want[3]
    if kind != "none":
        assert got[1][0].total_retries + got[1][0].total_hedges > 0
    # the same configuration in two candidate slots draws the same faults
    assert_same_reports(got[1][:2], got[1][4:], SLOS)


def test_outages_over_a_packed_fleet_equal_reference():
    """An outage window on one placement node takes down every function
    of the tenant placed there; the other tenant rides through."""
    out = []
    for pkg in (PORT, REF):
        F = pkg.faults
        a = pkg.gen.chain_workflow(4, seed=1, tenant="A")
        b = pkg.gen.fan_workflow(3, seed=2, tenant="B")
        fm = F.FaultModel(outages=(F.OutageWindow(node=0, start_s=0.0,
                                                  end_s=25.0),),
                          node_of={"A": 0, "B": 1}, outage_fail=0.8, seed=5)
        rm = F.ResilienceModel(default=F.ResiliencePolicy(max_retries=3,
                                                          backoff_s=2.0))
        eng = make_engine(pkg, faults=fm, resilience=rm,
                          cluster=pkg.engine.ClusterModel(32.0, 65536.0))
        wfs = [a.copy() for _ in range(6)] + [b.copy() for _ in range(6)]
        out.append(eng.run(wfs, arrival_sets(1, n=12, rate=0.5)[0]))
    assert out[0].by_tenant()["A"].total_failures > 0
    assert out[0].by_tenant()["B"].total_failures == 0
    assert_same_report(out[0], out[1], SLOS)


def test_policy_ladder_grants_and_degradation_equal_reference():
    out = []
    for pkg in (PORT, REF):
        F = pkg.faults
        ladder = [F.policy_ladder(lvl, 2.5) for lvl in range(7)]
        levels = [F.ladder_level(p) for p in ladder]
        spec = F.ResilienceSpec(max_retries=2, timeout_factor=3.0,
                                hedge_factor=1.5, grant_width=3)
        template = pkg.gen.diamond_workflow(2, seed=4)
        eng = make_engine(pkg, faults=fault_model(pkg, seed=9))
        rep = eng.run([template.copy() for _ in range(10)],
                      arrival_sets(1, n=10)[0])
        sat = rep.saturation()
        total, share = F.classify_failures(sat)
        names = list(template.nodes)
        start = {n: 0 for n in names}
        granted = F.grant_policies(start, sat, width=spec.grant_width,
                                   max_level=spec.max_level)
        capped = F.grant_policies({n: spec.max_level for n in names}, sat,
                                  width=2, max_level=spec.max_level)
        degraded = F.degrade_policies(
            {n: spec.max_level for n in names}, names[:3])
        model = spec.resilience_model(granted, {n: 1.5 for n in names})
        out.append(([dataclasses.astuple(p) for p in ladder], levels,
                     [dataclasses.astuple(spec.ladder(lvl, 3.0))
                      for lvl in range(spec.max_level + 1)],
                     total, share, granted, capped, degraded,
                     {k: dataclasses.astuple(p)
                      for k, p in model.policies.items()}))
    assert out[0][3] > 0
    assert_same(out[0], out[1])


@pytest.mark.parametrize("inner", ["aarc", "maff"])
def test_resilience_searcher_equals_reference(inner):
    """``make_searcher("resilience", ...)``: the joint (configs, policies)
    search, its result fields and trace, then a resumed config half."""
    out = []
    for pkg in (PORT, REF):
        template = pkg.gen.chain_workflow(3, seed=2)
        slo = pkg.gen.suggest_slo(template, slack=3.0)
        spec = pkg.faults.ResilienceSpec(
            faults=pkg.faults.FaultModel(default_transient=0.1,
                                         straggler_prob=0.1, seed=1),
            rate=0.5, n_instances=12, max_rounds=6, config_grant=16,
            target_attainment=0.8)
        searcher = pkg.search.make_searcher(
            "resilience", lambda: pkg.platform.SimulatedPlatform()
            .environment(), inner=inner, spec=spec)
        res = searcher.search(template.copy(), slo)
        view = [res.summary(), res.note, res.feasible,
                {n: (c.cpu, c.mem) for n, c in res.configs.items()},
                {n: dataclasses.astuple(p) for n, p in res.policies.items()},
                [dataclasses.astuple(s) for s in res.trace.samples],
                res.state.payload]
        view[0].pop("wall_time_s")
        resumed = searcher.resume(res.state, 8)
        view += [resumed.fleet_attainment, resumed.fleet_cost,
                 resumed.fleet_evals, resumed.n_samples,
                 {n: (c.cpu, c.mem) for n, c in resumed.configs.items()}]
        assert searcher.resume(res.state, 0) is res.state.result
        out.append(view)
    assert out[0][0]["fleet_evals"] > 0
    assert_same(out[0], out[1])
