"""AARC's search stack in the port against the reference, bit for bit.

The port keeps its own numpy copies of the Graph-Centric Scheduler, the
Priority Configurator, the critical-path queries, the MAFF and BO
baselines, the analytic platform and the degenerate-case execution path;
the same workflows and seeds go through both packages and every sample of
every trace must be equal, floats compared with ``==``. The measured
oracle runs under a fake clock in both packages.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from _hypothesis_compat import given, settings, st

from repro.core import critical_path as ref_cp
from repro.core import dag as ref_dag
from repro.core.backend import CallableBackend as RefCallableBackend
from repro.core.baselines.bo import bo_search as ref_bo
from repro.core.baselines.maff import maff_search as ref_maff
from repro.core.env import Environment as RefEnvironment
from repro.core.env import ExecutionError as RefExecutionError
from repro.core.priority import priority_configuration as ref_priority
from repro.core.resources import ResourceConfig as RefConfig
from repro.core.scheduler import GraphCentricScheduler as RefScheduler
from repro.serverless import function as ref_function
from repro.serverless import platform as ref_platform
from repro.serverless import workloads as ref_workloads
from repro_torch.core import critical_path as port_cp
from repro_torch.core import dag as port_dag
from repro_torch.core.backend import CallableBackend as PortCallableBackend
from repro_torch.core.baselines.bo import bo_search as port_bo
from repro_torch.core.baselines.maff import maff_search as port_maff
from repro_torch.core.env import Environment as PortEnvironment
from repro_torch.core.env import ExecutionError as PortExecutionError
from repro_torch.core.priority import priority_configuration as port_priority
from repro_torch.core.resources import ResourceConfig as PortConfig
from repro_torch.core.scheduler import GraphCentricScheduler as PortScheduler
from repro_torch.serverless import function as port_function
from repro_torch.serverless import platform as port_platform
from repro_torch.serverless import workloads as port_workloads

NAMES = list(ref_workloads.WORKLOADS)


def samples(env):
    """Every sample of a trace as a plain tuple (e2e, cost, configs,
    feasible, error, trial time, note, ...), comparable across packages."""
    return [dataclasses.astuple(s) for s in env.trace.samples]


def node_states(wf):
    return [(n.name, n.config.cpu, n.config.mem, n.runtime, n.scheduled,
             n.failed, n.fail_reason) for n in wf]


def configs(cfgs):
    return {name: (c.cpu, c.mem) for name, c in cfgs.items()}


def both_workflows(name):
    return ref_workloads.WORKLOADS[name](), port_workloads.WORKLOADS[name]()


def both_envs():
    return (ref_platform.SimulatedPlatform().environment(),
            port_platform.SimulatedPlatform().environment())


def test_paper_workloads_and_slos_are_copied():
    assert list(port_workloads.WORKLOADS) == NAMES
    for name in NAMES:
        ref_wf, port_wf = both_workflows(name)
        assert [dataclasses.astuple(n.payload) for n in ref_wf] == \
            [dataclasses.astuple(n.payload) for n in port_wf]
        assert [(n, ref_wf.successors(n)) for n in ref_wf.nodes] == \
            [(n, port_wf.successors(n)) for n in port_wf.nodes]
        assert port_workloads.workload_slo(name) == \
            ref_workloads.workload_slo(name)


# --------------------------------------------------------------------------
# Algorithm 1 and 2 on the paper's three workflows
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [1, 32])
@pytest.mark.parametrize("name", NAMES)
def test_scheduler_trace_equals_reference(name, batch_size):
    """The whole AARC search: every sample, the result and the nodes'
    final state. ``batch_size=32`` takes the Priority Configurator's
    batched probe-and-commit rounds (wider than the analytic backend's
    scalar crossover of 16)."""
    slo = ref_workloads.workload_slo(name)
    ref_wf, port_wf = both_workflows(name)
    ref_env, port_env = both_envs()
    want = RefScheduler(ref_env, batch_size=batch_size).schedule(ref_wf, slo)
    got = PortScheduler(port_env, batch_size=batch_size).schedule(port_wf,
                                                                   slo)
    assert samples(port_env) == samples(ref_env)
    assert configs(got.configs) == configs(want.configs)
    assert got.critical_path == want.critical_path
    assert (got.cost, got.e2e_runtime, got.n_samples) == \
        (want.cost, want.e2e_runtime, want.n_samples)
    assert node_states(port_wf) == node_states(ref_wf)
    assert port_env.trace.total_search_runtime == \
        ref_env.trace.total_search_runtime
    # the search tried configurations below a working-set floor
    assert any(s.error for s in ref_env.trace.samples)


@pytest.mark.parametrize("clamped", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_below_floor_execution_equals_reference(name, clamped):
    """The degenerate-case path's failure branch: one function below its
    working set, the sample (infinite e2e and the rate-only cost without a
    clamped estimate) and the nodes' failure flags and reasons."""
    ref_wf, port_wf = both_workflows(name)
    if clamped:
        ref_env, port_env = both_envs()
    else:
        ref_env = RefEnvironment(RefCallableBackend(
            lambda n: n.payload.runtime(n.config)))
        port_env = PortEnvironment(PortCallableBackend(
            lambda n: n.payload.runtime(n.config)))
    slo = ref_workloads.workload_slo(name)
    for wf, cfg in ((ref_wf, RefConfig), (port_wf, PortConfig)):
        for i, node in enumerate(wf):
            node.config = cfg(cpu=1.0 + i, mem=128.0 if i == 1 else 8192.0)
    want = ref_env.execute(ref_wf, slo, note="x")
    got = port_env.execute(port_wf, slo, note="x")
    assert got.error and not got.feasible
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert node_states(port_wf) == node_states(ref_wf)
    # and back above the floor: the flags clear as in the reference
    for wf in (ref_wf, port_wf):
        list(wf)[1].config = list(wf)[0].config.copy()
    assert dataclasses.astuple(port_env.execute(port_wf, slo)) == \
        dataclasses.astuple(ref_env.execute(ref_wf, slo))
    assert node_states(port_wf) == node_states(ref_wf)


def test_infeasible_slo_raises_in_both():
    ref_wf, port_wf = both_workflows("chatbot")
    ref_env, port_env = both_envs()
    with pytest.raises(ValueError, match="infeasible") as want:
        RefScheduler(ref_env).schedule(ref_wf, 1.0)
    with pytest.raises(ValueError, match="infeasible") as got:
        PortScheduler(port_env).schedule(port_wf, 1.0)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the baselines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method,name,kw", [
    ("maff", "ml_pipeline", {}),
    ("maff", "video_analysis", {"shrink": 0.6}),
    ("bo", "chatbot", {"n_rounds": 24, "seed": 3}),
    ("bo", "video_analysis", {"n_rounds": 16, "seed": 1, "batch_size": 4}),
])
def test_baseline_trace_equals_reference(method, name, kw):
    slo = ref_workloads.workload_slo(name)
    ref_wf, port_wf = both_workflows(name)
    ref_env, port_env = both_envs()
    ref_fn, port_fn = {"maff": (ref_maff, port_maff),
                       "bo": (ref_bo, port_bo)}[method]
    want = ref_fn(ref_wf, slo, ref_env, **kw)
    got = port_fn(port_wf, slo, port_env, **kw)
    assert samples(port_env) == samples(ref_env)
    assert len(samples(ref_env)) > 8
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert node_states(port_wf) == node_states(ref_wf)


# --------------------------------------------------------------------------
# the graph queries and Algorithm 2 on random DAGs
# --------------------------------------------------------------------------

@st.composite
def random_dag_pair(draw):
    """One random weighted DAG (edges only i -> j with i < j), built in
    both packages, each node carrying a response surface of its own."""
    n = draw(st.integers(3, 12))
    names = [f"n{i}" for i in range(n)]
    specs = []
    for name in names:
        floor = draw(st.floats(128.0, 2048.0))
        specs.append(dict(name=name,
                          cpu_work=draw(st.floats(0.5, 80.0)),
                          parallel_frac=draw(st.floats(0.0, 0.95)),
                          mem_floor=floor,
                          mem_knee=floor + draw(st.floats(0.0, 1024.0)),
                          mem_penalty=draw(st.floats(0.5, 4.0)),
                          io_time=draw(st.floats(0.1, 3.0))))
    edges = [(names[i], names[j]) for i in range(n) for j in range(i + 1, n)
             if draw(st.booleans()) and draw(st.integers(0, 2)) == 0]
    runtimes = [draw(st.floats(0.1, 10.0)) for _ in names]
    pair = []
    for dag, fn in ((ref_dag, ref_function), (port_dag, port_function)):
        wf = dag.Workflow("rand")
        for spec, rt in zip(specs, runtimes):
            wf.add_function(spec["name"], payload=fn.FunctionSpec(**spec))
            wf.nodes[spec["name"]].runtime = rt
        for a, b in edges:
            wf.add_edge(a, b)
        pair.append(wf)
    slack = draw(st.floats(1.05, 3.0))
    return pair[0], pair[1], slack


def subpaths(sps):
    return [(sp.start, sp.end, sp.interior) for sp in sps]


@given(random_dag_pair())
@settings(max_examples=40, deadline=None)
def test_graph_queries_equal_reference_on_random_dags(pair):
    ref_wf, port_wf, _ = pair
    cp = ref_cp.find_critical_path(ref_wf)
    assert port_cp.find_critical_path(port_wf) == cp
    assert port_wf.topological_order() == ref_wf.topological_order()
    assert port_wf.end_to_end_latency() == ref_wf.end_to_end_latency()
    want = ref_cp.find_detour_subpath(ref_wf, cp)
    got = port_cp.find_detour_subpath(port_wf, cp)
    assert subpaths(got) == subpaths(want)
    for sp in want:
        assert port_cp.runtime_sum(port_wf, cp, sp.start, sp.end) == \
            ref_cp.runtime_sum(ref_wf, cp, sp.start, sp.end)


@given(random_dag_pair())
@settings(max_examples=25, deadline=None)
def test_priority_and_scheduler_equal_reference_on_random_dags(pair):
    """Algorithm 2 alone on the critical path, then Algorithm 1 whole, at
    an SLO of ``slack`` x the base configuration's latency. Memory floors
    up to 2 GB put some halvings below a working set."""
    ref_wf, port_wf, slack = pair
    ref_env, port_env = both_envs()
    base = ref_env.execute(ref_wf, 1e9)
    assert dataclasses.astuple(port_env.execute(port_wf, 1e9)) == \
        dataclasses.astuple(base)
    slo = base.e2e_runtime * slack
    cp = ref_cp.find_critical_path(ref_wf)
    want = ref_priority(ref_wf, cp, slo, ref_env)
    got = port_priority(port_wf, cp, slo, port_env)
    assert configs(got) == configs(want)
    assert samples(port_env) == samples(ref_env)
    assert node_states(port_wf) == node_states(ref_wf)

    ref_env, port_env = both_envs()
    want = RefScheduler(ref_env).schedule(ref_wf, slo)
    got = PortScheduler(port_env).schedule(port_wf, slo)
    assert samples(port_env) == samples(ref_env)
    assert configs(got.configs) == configs(want.configs)
    assert (got.cost, got.e2e_runtime) == (want.cost, want.e2e_runtime)


# --------------------------------------------------------------------------
# the measured oracle
# --------------------------------------------------------------------------

class FakeClock:
    """Stands in for the ``time`` module: ``perf_counter`` steps by a fixed,
    exactly representable delta on every call."""

    def __init__(self, delta=2.0 ** -10):
        self.t, self.delta = 0.0, delta

    def perf_counter(self):
        self.t += self.delta
        return self.t


@pytest.fixture
def fake_clocks(monkeypatch):
    """The ``time`` name of both platform modules on its own fake clock
    (jax's own clock reads stay real)."""
    monkeypatch.setattr(ref_platform, "time", FakeClock())
    monkeypatch.setattr(port_platform, "time", FakeClock())


def measured(fn, node):
    try:
        return fn(node)
    except (RefExecutionError, PortExecutionError) as exc:
        return ("raised", type(exc).__name__, str(exc))


def test_measured_oracle_equals_jax_oracle(fake_clocks):
    ref = ref_platform.JaxMeasuredOracle()
    port = port_platform.TorchMeasuredOracle(device="cpu")
    n_raised = 0
    for name in NAMES:
        ref_wf, port_wf = both_workflows(name)
        for ref_node, port_node in zip(ref_wf, port_wf):
            for cpu in (0.1, 1.0, 4.0, 10.0):
                for mem in (128.0, 512.0, 3072.0, 10240.0):
                    ref_node.config = RefConfig(cpu=cpu, mem=mem)
                    port_node.config = PortConfig(cpu=cpu, mem=mem)
                    want = measured(ref, ref_node)
                    got = measured(port, port_node)
                    assert got == want
                    n_raised += isinstance(want, tuple)
    assert n_raised > 0          # below-floor configurations raise in both


def test_scheduler_over_measured_oracle_equals_reference(fake_clocks):
    """Algorithm 1 with the measured oracle as an Environment's backend
    (no clamped estimate: a failing sample is charged an infinite e2e)."""
    name = "ml_pipeline"
    slo = ref_workloads.workload_slo(name)
    ref_wf, port_wf = both_workflows(name)
    ref_env = RefEnvironment(ref_platform.JaxMeasuredOracle())
    port_env = PortEnvironment(port_platform.TorchMeasuredOracle(
        device="cpu"))
    want = RefScheduler(ref_env).schedule(ref_wf, slo)
    got = PortScheduler(port_env).schedule(port_wf, slo)
    assert samples(port_env) == samples(ref_env)
    assert configs(got.configs) == configs(want.configs)
    assert any(s.error for s in ref_env.trace.samples)


def test_measured_oracle_times_a_real_unit_on_the_cpu():
    unit = port_platform.TorchMeasuredOracle(device="cpu").unit()
    assert 0.0 < unit < 1.0


def test_measured_oracle_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_platform.TorchMeasuredOracle()
