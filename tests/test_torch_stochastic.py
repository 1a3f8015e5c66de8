"""The port's stochastic backend against the reference's, bit for bit.

``StochasticBackend`` multiplies the analytic surface by log-normal
invocation noise from a seeded numpy stream; its paired replay-stream
contract (``config_surface`` + ``replay_noise``) draws one (instance,
function) noise tensor per ``FleetEngine.run_many`` plane. From the same
seed the port must draw the same numbers in the same order as the
reference, its noisy planes must give the reference's reports field by
field, and searches over ``make_env(noise_sigma=...)`` must record the
reference's traces.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (before repro.serverless: circular import)
from repro.core import cost as ref_cost
from repro.core import engine as ref_engine
from repro.core import resources as ref_resources
from repro.core.baselines.bo import bo_search as ref_bo
from repro.core.baselines.maff import maff_search as ref_maff
from repro.core.scheduler import GraphCentricScheduler as RefScheduler
from repro.serverless import generator as ref_generator
from repro.serverless import platform as ref_platform
from repro.serverless import workloads as ref_workloads
from repro_torch.core import cost as port_cost
from repro_torch.core import engine as port_engine
from repro_torch.core import resources as port_resources
from repro_torch.core.baselines.bo import bo_search as port_bo
from repro_torch.core.baselines.maff import maff_search as port_maff
from repro_torch.core.scheduler import GraphCentricScheduler as PortScheduler
from repro_torch.serverless import generator as port_generator
from repro_torch.serverless import platform as port_platform
from repro_torch.serverless import workloads as port_workloads

from _torch_fleet_parity import assert_same, assert_same_reports, differences

REF = types.SimpleNamespace(
    engine=ref_engine, Config=ref_resources.ResourceConfig,
    gen=ref_generator, platform=ref_platform, workloads=ref_workloads,
    Scheduler=RefScheduler, bo=ref_bo, maff=ref_maff)
PORT = types.SimpleNamespace(
    engine=port_engine, Config=port_resources.ResourceConfig,
    gen=port_generator, platform=port_platform, workloads=port_workloads,
    Scheduler=PortScheduler, bo=port_bo, maff=port_maff)

TOPOLOGIES = {
    "chain": lambda g: g.chain_workflow(5, seed=11),
    "fan": lambda g: g.fan_workflow(4, seed=12),
    "diamond": lambda g: g.diamond_workflow(2, seed=13),
    "layered": lambda g: g.layered_workflow(10, n_layers=3, seed=14),
}
SLOS = (20.0, 60.0)


def candidate_sets(pkg, template, n_cand, seed=0):
    rng = np.random.default_rng(seed)
    return [{n.name: pkg.Config(cpu=float(rng.uniform(1.0, 8.0)),
                                mem=float(rng.uniform(256.0, 8192.0)))
             for n in template} for _ in range(n_cand)]


def arrival_sets(n_seeds, n=6, rate=0.25):
    return [ref_engine.PoissonArrivals(rate, n, seed=s).times()
            for s in range(n_seeds)]


class _RefMirrorPricing(ref_cost.PricingModel):
    def function_cost(self, runtime_s, config):
        return super().function_cost(runtime_s, config)


class _PortMirrorPricing(port_cost.PricingModel):
    def function_cost(self, runtime_s, config):
        return super().function_cost(runtime_s, config)


PLANES = {
    "fast": lambda pkg: {},
    "constrained": lambda pkg: dict(
        cluster=pkg.engine.ClusterModel(total_cpu=12.0, total_mem_mb=16384.0),
        cold_start=pkg.engine.ColdStartModel(delay_s=1.0, keep_alive_s=30.0)),
    "planned": lambda pkg: dict(pricing=(_PortMirrorPricing() if pkg is PORT
                                         else _RefMirrorPricing())),
}


def stochastic_engine(pkg, seed, sigma=0.05, pricing=None, **kw):
    return pkg.engine.FleetEngine(
        pkg.platform.StochasticBackend(noise_sigma=sigma, seed=seed),
        pricing=pricing or pkg.platform.SimulatedPlatform().pricing, **kw)


def test_backend_draws_equal_reference():
    """Scalar, batch, candidate-plane and replay-plane draws in one
    interleaved sequence; the noise-free surface advances nothing."""
    out = []
    for pkg in (PORT, REF):
        wf = pkg.gen.layered_workflow(8, n_layers=3, seed=2)
        nodes = list(wf)
        backend = pkg.platform.StochasticBackend(noise_sigma=0.025, seed=5)
        cands = candidate_sets(pkg, wf, 3, 1)
        cpu = np.array([[c[n.name].cpu for n in nodes] for c in cands])
        mem = np.array([[c[n.name].mem for n in nodes] for c in cands])
        draws = [backend.invoke(nodes[0]), backend.invoke_clamped(nodes[1]),
                 backend.invoke_batch(nodes),
                 backend.invoke_config_batch(nodes, cpu, mem),
                 backend.config_surface(nodes, cpu, mem),
                 backend.replay_noise(4, len(nodes)),
                 backend.invoke_batch(nodes[:3]),
                 [n.fail_reason for n in nodes]]
        state = backend.rng.bit_generator.state
        assert (backend.deterministic, backend.batch_safe,
                backend.scalar_round_max) == (False, True, 8)
        assert pkg.platform.AnalyticBackend().batch_safe
        assert pkg.platform.AnalyticBackend().replay_noise(2, 3) is None
        assert pkg.platform.StochasticBackend(
            noise_sigma=0.0).replay_noise(2, 3) is None
        out.append((draws, state))
    assert_same(out[0], out[1])


@pytest.mark.parametrize("plane", list(PLANES))
@pytest.mark.parametrize("kind", list(TOPOLOGIES))
def test_noisy_planes_equal_reference(kind, plane):
    """The paired noisy plane on each of its routes, against the
    reference's; the port on both sweep backends (a noisy plane keeps the
    numpy sweep in both packages)."""
    want_t = TOPOLOGIES[kind](REF.gen)
    want = stochastic_engine(REF, 99, **PLANES[plane](REF)).run_many(
        want_t, candidate_sets(REF, want_t, 3, 7), arrival_sets(2))
    got_t = TOPOLOGIES[kind](PORT.gen)
    for sweep in ("torch", "numpy"):
        eng = stochastic_engine(PORT, 99, plane_backend=sweep,
                                **PLANES[plane](PORT))
        assert eng.batch_eligibility(got_t, [{}])["plane"] == plane
        got = eng.run_many(got_t, candidate_sets(PORT, got_t, 3, 7),
                           arrival_sets(2))
        assert_same_reports(got, want, SLOS)


@pytest.mark.parametrize("plane", ["fast", "constrained"])
def test_same_config_in_two_slots_scores_identically(plane):
    """Paired replay: one noise tensor for all candidates, so the same
    configuration in two candidate slots is the same experiment; the noise
    is really applied, and sigma 0 is the analytic plane."""
    template = TOPOLOGIES["layered"](PORT.gen)
    cfg = candidate_sets(PORT, template, 1, 6)[0]
    kw = dict(device="cpu", **PLANES[plane](PORT))
    reports = stochastic_engine(PORT, 123, **kw).run_many(
        template, [cfg, cfg], arrival_sets(2))
    assert_same_reports(reports[:2], reports[2:], SLOS)
    exact = port_engine.FleetEngine(port_platform.AnalyticBackend(),
                                    **kw).run_many(template, [cfg],
                                                   arrival_sets(2))
    assert differences(reports[0].finishes, exact[0].finishes)
    silent = stochastic_engine(PORT, 123, sigma=0.0, **kw).run_many(
        template, [cfg], arrival_sets(2))
    assert_same_reports(silent, exact, SLOS)


def test_platform_and_env_factories_equal_reference():
    """``SimulatedPlatform(noise_sigma=, seed=)``, ``make_env`` and
    ``make_scaled_env`` build the reference's backends: the same noisy
    and scaled samples of one workflow."""
    out = []
    for pkg in (PORT, REF):
        plat = pkg.platform.SimulatedPlatform(noise_sigma=0.025, seed=3)
        assert type(plat.backend).__name__ == "StochasticBackend"
        assert type(pkg.platform.SimulatedPlatform().backend).__name__ == \
            "AnalyticBackend"
        envs = [plat.environment(),
                pkg.platform.make_env(noise_sigma=0.025, seed=4),
                pkg.platform.make_scaled_env(1.5)]
        assert envs[2].backend.input_scale == 1.5
        rows = []
        for env in envs:
            wf = pkg.workloads.video_analysis()
            for _ in range(3):
                env.execute(wf, slo=600.0)
            rows.append([dataclasses.astuple(s) for s in env.trace.samples])
        out.append(rows)
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("method", ["aarc", "bo", "maff"])
@pytest.mark.parametrize("name", sorted(ref_workloads.WORKLOADS))
def test_noisy_searches_equal_reference(name, method, seed):
    """AARC, BO and MAFF over ``make_env(noise_sigma=0.025, seed=...)``:
    every sample of every trace equal to the reference's."""
    out = []
    for pkg in (PORT, REF):
        env = pkg.platform.make_env(noise_sigma=0.025, seed=seed)
        wf = pkg.workloads.WORKLOADS[name]()
        slo = pkg.workloads.workload_slo(name)
        if method == "aarc":
            r = pkg.Scheduler(env, batch_size=8).schedule(wf, slo)
            found = (r.cost, r.e2e_runtime, r.n_samples)
        elif method == "bo":
            found = pkg.bo(wf, slo, env, n_rounds=24, seed=seed)
        else:
            found = pkg.maff(wf, slo, env)
        out.append((found, [dataclasses.astuple(s)
                            for s in env.trace.samples]))
    assert_same(out[0], out[1])
