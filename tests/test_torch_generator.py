"""The port's workflow generator against the reference's, bit for bit.

The same seed must draw the same topology, the same function specs (every
response-surface constant compared with ``==``) and the same affinity
profiles in both packages; the structural keys, config transfer, drift
schedules and ``suggest_slo`` must agree too, and the errors carry the
reference's messages.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (before repro.serverless: circular import)
from repro.core import resources as ref_resources
from repro.serverless import generator as ref_generator
from repro_torch.core import resources as port_resources
from repro_torch.serverless import generator as port_generator

from _torch_fleet_parity import assert_same

REF = types.SimpleNamespace(gen=ref_generator,
                            Config=ref_resources.ResourceConfig)
PORT = types.SimpleNamespace(gen=port_generator,
                             Config=port_resources.ResourceConfig)

CASES = {
    "chain": dict(n=7),
    "fan": dict(width=5),
    "diamond": dict(n_diamonds=3),
    "layered": dict(n_nodes=24, n_layers=5, p_edge=0.4),
}


def shape(wf):
    """Name, tenant, nodes in insertion order with their specs, edges and
    topological order."""
    return (wf.name, wf.tenant, wf.identity,
            [(n.name, dataclasses.astuple(n.payload)) for n in wf],
            [(n, wf.successors(n)) for n in wf.nodes],
            wf.topological_order())


@pytest.mark.parametrize("profile", [None, "cpu_bound", "io_bound"])
@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("kind", list(CASES))
def test_generators_equal_reference(kind, seed, profile):
    kw = dict(CASES[kind], seed=seed, profile=profile, tenant=f"t{seed}")
    got = [shape(getattr(PORT.gen, f"{kind}_workflow")(**kw)),
           shape(PORT.gen.generate(kind, **kw))]
    want = [shape(getattr(REF.gen, f"{kind}_workflow")(**kw)),
            shape(REF.gen.generate(kind, **kw))]
    assert got == want


def test_profiles_and_random_specs_equal_reference():
    assert list(PORT.gen.AFFINITY_PROFILES) == list(REF.gen.AFFINITY_PROFILES)
    for name, prof in REF.gen.AFFINITY_PROFILES.items():
        assert dataclasses.astuple(PORT.gen.AFFINITY_PROFILES[name]) == \
            dataclasses.astuple(prof)
    assert list(PORT.gen.GENERATORS) == list(REF.gen.GENERATORS)
    for profile in [None, *REF.gen.AFFINITY_PROFILES]:
        specs = []
        for pkg in (PORT, REF):
            rng = np.random.default_rng(4)
            specs.append([dataclasses.astuple(
                pkg.gen.random_spec(f"s{i}", rng, profile))
                for i in range(20)])
        assert specs[0] == specs[1]


def error(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_errors_carry_the_reference_messages():
    msgs = []
    for gen in (PORT.gen, REF.gen):
        msgs.append([
            error(lambda: gen.generate("bogus")),
            error(lambda: gen.chain_workflow(0)),
            error(lambda: gen.fan_workflow(0)),
            error(lambda: gen.diamond_workflow(0)),
            error(lambda: gen.layered_workflow(1)),
            error(lambda: gen.DriftEvent(1, "bogus", 1.0)),
            error(lambda: gen.DriftEvent(-1, "load", 1.0)),
            error(lambda: gen.DriftEvent(1, "load", 0.0)),
            error(lambda: gen.DriftEvent(1, "coldstart", -1.0)),
            error(lambda: gen.transfer_configs(
                gen.chain_workflow(3), {}, gen.fan_workflow(3))),
        ])
    assert msgs[0] == msgs[1]
    assert msgs[0][0].startswith("unknown workflow kind 'bogus'")


@pytest.mark.parametrize("kind", list(CASES))
def test_signatures_and_transfer_equal_reference(kind):
    """``topology_signature`` (plain and with profiles), ``degree_bucket``
    and ``transfer_configs`` between two seeds of one family, exact and
    approximate."""
    out = []
    for pkg in (PORT, REF):
        a = pkg.gen.generate(kind, **CASES[kind], seed=1)
        b = pkg.gen.generate(kind, **CASES[kind], seed=2)
        rng = np.random.default_rng(9)
        configs = {n: pkg.Config(cpu=float(rng.uniform(1, 8)),
                                 mem=float(rng.uniform(256, 8192)))
                   for n in a.nodes}
        row = [pkg.gen.topology_signature(a),
               pkg.gen.topology_signature(a, with_profiles=True),
               pkg.gen.degree_bucket(a), pkg.gen.degree_bucket(b, cap=2),
               pkg.gen.topology_signature(a) == pkg.gen.topology_signature(b)]
        try:
            moved = pkg.gen.transfer_configs(a, configs, b, approx=True)
            row.append({n: (c.cpu, c.mem) for n, c in moved.items()})
        except ValueError as exc:
            row.append(str(exc))
        out.append(row)
    assert_same(out[0], out[1])


def test_drift_schedules_equal_reference():
    out = []
    for gen in (PORT.gen, REF.gen):
        scheds = [gen.DriftSchedule(), gen.load_shift_schedule(2, 2.5),
                  gen.input_mix_schedule(1, 1.4),
                  gen.coldstart_schedule(3, 2.0, keep_alive_s=60.0),
                  gen.DriftSchedule((gen.DriftEvent(4, "input", 1.2),
                                     gen.DriftEvent(1, "load", 3.0),
                                     gen.DriftEvent(4, "coldstart", 0.0)))]
        scheds += [gen.random_drift_schedule(10, seed=s, n_events=3,
                                             kinds=("load", "input",
                                                    "coldstart"))
                   for s in range(4)]
        scheds.append(gen.random_drift_schedule(1))
        rows = []
        for sched in scheds:
            rows.append((sched.empty,
                         [dataclasses.astuple(e) for e in sched.events],
                         [(dataclasses.astuple(sched.conditions(ep)),
                           sched.conditions(ep).baseline, sched.regime(ep))
                          for ep in range(8)]))
        out.append((gen.DRIFT_KINDS, rows))
    assert out[0] == out[1]


@pytest.mark.parametrize("scale", [1.0, 1.5])
@pytest.mark.parametrize("kind", list(CASES))
def test_suggest_slo_equals_reference(kind, scale):
    got = PORT.gen.suggest_slo(PORT.gen.generate(kind, **CASES[kind], seed=3),
                               slack=1.25, input_scale=scale)
    want = REF.gen.suggest_slo(REF.gen.generate(kind, **CASES[kind], seed=3),
                               slack=1.25, input_scale=scale)
    assert got == want
    oom = []
    for gen, cfg in ((PORT.gen, PORT.Config), (REF.gen, REF.Config)):
        wf = gen.chain_workflow(3, seed=0, profile="mem_bound")
        for node in wf:
            node.config = cfg(cpu=1.0, mem=128.0)
        oom.append(error(lambda: gen.suggest_slo(wf)))
    assert oom[0] == oom[1] == "workflow OOMs even at the base config"
