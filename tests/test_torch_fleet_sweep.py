"""The port's fast-plane sweep against the reference's fleet engine.

``repro_torch.core.engine.fast_plane_sweep`` is the torch fp64 counterpart
of the reference's jitted ``lax.scan`` sweep behind
``FleetEngine(plane_backend="jax")``. Standing in for it (``_sweep_jax``
monkeypatched), it must make the reference's fleet reports identical to
the numpy plane's; and on random DAGs and runtimes it must equal the
port's numpy sweep and the reference's numpy plane bit for bit. The
port's own engine, whose fast plane runs the sweep, gives the same
reports on its torch and numpy planes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _hypothesis_compat import given, settings, st

from repro.core.engine import FleetCarry, FleetEngine, PoissonArrivals
from repro.core.resources import ResourceConfig
from repro.serverless.generator import (chain_workflow, diamond_workflow,
                                        fan_workflow, layered_workflow)
from repro.serverless.platform import SimulatedPlatform
from repro_torch.core import dag as port_dag
from repro_torch.core import engine as port_engine
from repro_torch.core.engine import fast_plane_sweep, numpy_plane_sweep
from repro_torch.core.resources import ResourceConfig as PortConfig
from repro_torch.serverless import generator as port_generator
from repro_torch.serverless.platform import \
    SimulatedPlatform as PortSimulatedPlatform

TOPOLOGIES = {
    "chain": lambda: chain_workflow(5, seed=11),
    "fan": lambda: fan_workflow(4, seed=12),
    "diamond": lambda: diamond_workflow(2, seed=13),
    "layered": lambda: layered_workflow(10, n_layers=3, seed=14),
}
PORT_TOPOLOGIES = {
    "chain": lambda: port_generator.chain_workflow(5, seed=11),
    "fan": lambda: port_generator.fan_workflow(4, seed=12),
    "diamond": lambda: port_generator.diamond_workflow(2, seed=13),
    "layered": lambda: port_generator.layered_workflow(10, n_layers=3,
                                                       seed=14),
}


# helpers copied from tests/test_replay_batch.py
def make_engine(**kw):
    env = SimulatedPlatform().environment()
    return FleetEngine(env.backend, pricing=env.pricing, **kw)


def candidate_sets(template, n_cand, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_cand):
        out.append({n.name: ResourceConfig(cpu=float(rng.uniform(1.0, 8.0)),
                                           mem=float(rng.uniform(1024.0,
                                                                 8192.0)))
                    for n in template})
    return out


def arrival_sets(n_seeds, n=6, rate=0.25, start=0.0):
    return [PoissonArrivals(rate, n, seed=s, start=start).times()
            for s in range(n_seeds)]


def assert_reports_identical(got, want):
    """Every compared field exact — the acceptance-criteria bar."""
    assert np.array_equal(got.arrivals, want.arrivals)
    assert np.array_equal(got.finishes, want.finishes)
    assert np.array_equal(got.latencies, want.latencies)
    assert np.array_equal(got.queue_delays, want.queue_delays)
    assert np.array_equal(got.cold_delays, want.cold_delays)
    assert np.array_equal(got.costs, want.costs)
    assert np.array_equal(got.failed_mask, want.failed_mask)
    assert got.makespan == want.makespan
    assert got.queue_delay_by_function == want.queue_delay_by_function
    assert got.total_cost == want.total_cost
    assert got.total_queue_delay == want.total_queue_delay
    assert got.p50 == want.p50 and got.p99 == want.p99


def checked_sweep(calls):
    """A stand-in for ``FleetEngine._sweep_jax``: the port's sweep on the
    CPU, held to the port's numpy sweep on every call; the shapes of the
    sweeps served are appended to ``calls``."""
    def sweep(self, template, order, col, t_all, rt):
        got = fast_plane_sweep(template, order, col, t_all, rt,
                               device="cpu")
        assert got.dtype == np.float64
        assert np.array_equal(got, numpy_plane_sweep(template, order, col,
                                                     t_all, rt))
        calls.append(got.shape)
        return got
    return sweep


@pytest.fixture
def port_sweep_stands_in(monkeypatch):
    calls = []
    monkeypatch.setattr(FleetEngine, "_sweep_jax", checked_sweep(calls))
    return calls


@pytest.mark.parametrize("kind", list(TOPOLOGIES))
def test_reference_jax_plane_with_port_sweep_matches_numpy_bitwise(
        kind, port_sweep_stands_in):
    """The reference's own jax-plane test (``tests/test_replay_batch.py``),
    on every topology of that file, with the port's sweep standing in."""
    template = TOPOLOGIES[kind]()
    cands = candidate_sets(template, 3, seed=16)
    seeds = arrival_sets(2)
    carry = FleetCarry(clock=0.0, warm={}, busy=[(700.0, 2.0, 512.0)])
    numpy_reports = make_engine().run_many(template, cands, seeds,
                                           carry=carry)
    jax_reports = make_engine(plane_backend="jax").run_many(
        template, cands, seeds, carry=carry)
    assert port_sweep_stands_in == [(3, 12)]
    assert len(jax_reports) == len(numpy_reports) == 6
    for got, want in zip(jax_reports, numpy_reports):
        assert_reports_identical(got, want)


@given(st.integers(4, 24), st.integers(2, 6), st.floats(0.1, 0.9),
       st.integers(0, 10_000))
@settings(max_examples=12, deadline=None)
def test_port_sweep_equals_reference_numpy_plane_on_random_dags(
        n_nodes, n_layers, p_edge, seed):
    """Random layered DAGs, candidates and arrivals through the reference's
    engine: its numpy plane against the port's sweep, and the torch sweep
    against the port's numpy sweep."""
    calls = []
    orig = FleetEngine._sweep_jax
    FleetEngine._sweep_jax = checked_sweep(calls)
    try:
        template = layered_workflow(n_nodes, n_layers=n_layers,
                                    p_edge=p_edge, seed=seed)
        cands = candidate_sets(template, 4, seed=seed)
        seeds = arrival_sets(3, n=5, rate=0.5)
        want = make_engine().run_many(template, cands, seeds)
        got = make_engine(plane_backend="jax").run_many(template, cands,
                                                        seeds)
    finally:
        FleetEngine._sweep_jax = orig
    assert calls == [(4, 15)]
    for g, w in zip(got, want):
        assert_reports_identical(g, w)


@given(st.integers(2, 16), st.integers(1, 8), st.integers(1, 40),
       st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_torch_sweep_equals_numpy_sweep_on_random_arrays(n, n_cand, n_inst,
                                                         seed):
    """Any DAG (edges only i -> j with i < j), runtimes spanning many
    magnitudes with some infinite (failed, unbounded), unsorted arrivals:
    the torch sweep and the numpy sweep agree bit for bit."""
    rng = np.random.default_rng(seed)
    wf = port_dag.Workflow("rand")
    names = [f"n{i}" for i in range(n)]
    for name in names:
        wf.add_function(name)
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < 0.3:
                wf.add_edge(names[i], names[j])
    order = wf.topological_order()
    col = {name: i for i, name in enumerate(names)}
    rt = np.exp(rng.uniform(-8.0, 8.0, size=(n_cand, n)))
    rt[rng.random((n_cand, n)) < 0.05] = np.inf
    t_all = rng.uniform(0.0, 1e4, size=n_inst)
    got = fast_plane_sweep(wf, order, col, t_all, rt, device="cpu")
    want = numpy_plane_sweep(wf, order, col, t_all, rt)
    assert got.shape == (n_cand, n_inst)
    assert np.array_equal(got, want)


def test_sweep_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wf = port_dag.Workflow("one")
    wf.add_function("a")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fast_plane_sweep(wf, ["a"], {"a": 0}, np.zeros(2), np.ones((1, 1)))


@pytest.mark.parametrize("kind", list(TOPOLOGIES))
def test_port_engine_torch_plane_equals_its_numpy_plane(kind,
                                                        monkeypatch):
    """``FleetEngine(plane_backend="torch", device="cpu")`` of the port
    against its ``plane_backend="numpy"``: one sweep on the torch plane,
    none on the numpy plane, the same reports bit for bit."""
    template = PORT_TOPOLOGIES[kind]()
    rng = np.random.default_rng(16)
    cands = [{n.name: PortConfig(cpu=float(rng.uniform(1.0, 8.0)),
                                 mem=float(rng.uniform(1024.0, 8192.0)))
              for n in template} for _ in range(3)]
    seeds = arrival_sets(2)
    sweeps = []
    real = port_engine.fast_plane_sweep

    def counted(*args, **kw):
        sweeps.append(kw["device"])
        return real(*args, **kw)

    monkeypatch.setattr(port_engine, "fast_plane_sweep", counted)
    plat = PortSimulatedPlatform()
    reports = {}
    for plane in ("torch", "numpy"):
        eng = port_engine.FleetEngine(plat.backend, pricing=plat.pricing,
                                      plane_backend=plane, device="cpu")
        reports[plane] = eng.run_many(template, cands, seeds)
    assert sweeps == ["cpu"]
    assert len(reports["torch"]) == 6
    for got, want in zip(reports["torch"], reports["numpy"]):
        assert_reports_identical(got, want)
        assert got.busy_by_function == want.busy_by_function
