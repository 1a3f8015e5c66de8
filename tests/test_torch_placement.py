"""The port's placement layer against the reference's, bit for bit.

The same tenant cells (templates from each package's generator with one
seed, configurations drawn with numpy from one seed) go through both
packages' ``core/placement.py`` on the CPU: constraints, the heavy cap,
the greedy + seeded local search solver, the round-robin ablation,
scores, interference multipliers and whole plans must be equal, floats
compared with ``==``, and the error messages must be the reference's.
"""
import math
import types

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core  # noqa: F401  (before repro.serverless: circular import)
from repro.core import dag as ref_dag
from repro.core import engine as ref_engine
from repro.core import placement as ref_placement
from repro.core import resources as ref_resources
from repro.serverless import function as ref_function
from repro.serverless import generator as ref_gen
from repro_torch.core import dag as port_dag
from repro_torch.core import engine as port_engine
from repro_torch.core import placement as port_placement
from repro_torch.core import resources as port_resources
from repro_torch.serverless import function as port_function
from repro_torch.serverless import generator as port_gen

REF = types.SimpleNamespace(dag=ref_dag, engine=ref_engine,
                            placement=ref_placement,
                            resources=ref_resources,
                            function=ref_function, gen=ref_gen)
PORT = types.SimpleNamespace(dag=port_dag, engine=port_engine,
                             placement=port_placement,
                             resources=port_resources,
                             function=port_function, gen=port_gen)

#: (cpu, mem) choices the drawn configurations pick from
CPUS = (0.5, 1.0, 2.0, 4.0, 8.0)
MEMS = (512.0, 1024.0, 2048.0, 4096.0, 8192.0)


def _cells(pkg, n, *, size=6, seed0=0, config_seed=None, tenant="t"):
    """``n`` tenant cells: chain, fan and layered templates in turn, and,
    with ``config_seed``, a drawn configuration for every function."""
    gen = pkg.gen
    rng = (np.random.default_rng(config_seed) if config_seed is not None
           else None)
    cells = []
    for i in range(n):
        kw = dict(seed=seed0 + i, tenant=f"{tenant}{i}")
        if i % 3 == 0:
            wf = gen.chain_workflow(size, **kw)
        elif i % 3 == 1:
            wf = gen.fan_workflow(size, **kw)
        else:
            wf = gen.layered_workflow(size + 2, n_layers=3, **kw)
        configs = {}
        if rng is not None:
            for name in wf.topological_order():
                configs[name] = pkg.resources.ResourceConfig(
                    cpu=CPUS[int(rng.integers(len(CPUS)))],
                    mem=MEMS[int(rng.integers(len(MEMS)))])
        cells.append(pkg.placement.TenantCell(template=wf, configs=configs,
                                              slo=30.0 + i))
    return cells


def _cluster(pkg, cpu):
    if cpu is None:
        return None
    return pkg.engine.ClusterModel(total_cpu=cpu, total_mem_mb=cpu * 1024.0)


def _constraints(c):
    return (c.chatty, c.heavy)


def _solution(s):
    return (sorted(s.assignment.items()), s.n_bins, s.score, s.method)


def _plan(p):
    return (p.cluster.total_cpu, p.cluster.total_mem_mb,
            _constraints(p.constraints), _solution(p.solution),
            sorted(p.multipliers.items()))


def _hand_built(pkg):
    """A tenant whose edges are and are not chatty, and whose functions
    are heavy by profile, by working set, or not at all."""
    def fn(name, io=0.5, profile="", floor=256.0):
        return pkg.function.FunctionSpec(
            name=name, cpu_work=2.0, parallel_frac=0.5, mem_floor=floor,
            mem_knee=2.0 * floor, io_time=io, profile=profile)
    wf = pkg.dag.Workflow("w", tenant="T")
    wf.add_function("a", payload=fn("a", io=2.0))
    wf.add_function("b", payload=fn("b", io=1.5))
    wf.add_function("c", payload=fn("c", io=0.1))
    wf.add_function("h1", payload=fn("h1", profile="mem_bound"))
    wf.add_function("h2", payload=fn("h2", floor=4096.0))
    wf.add_function("nh", payload=fn("nh", profile="cpu_bound",
                                     floor=4096.0))
    wf.add_function("bare")
    for src, dst in (("a", "b"), ("b", "c"), ("c", "h1"), ("h1", "h2"),
                     ("h2", "nh"), ("nh", "bare")):
        wf.add_edge(src, dst)
    return [pkg.placement.TenantCell(template=wf, configs={})]


@pytest.mark.parametrize("chatty_io_s", [1.0, 3.0, 6.0])
def test_constraints_equal_reference(chatty_io_s):
    for make in (_hand_built, lambda pkg: _cells(pkg, 6, size=7, seed0=3)):
        got = port_placement.derive_constraints(
            make(PORT), port_placement.PlacementSpec(chatty_io_s=chatty_io_s))
        want = ref_placement.derive_constraints(
            make(REF), ref_placement.PlacementSpec(chatty_io_s=chatty_io_s))
        assert _constraints(got) == _constraints(want)
        assert got.heavy_set == want.heavy_set
    hand = port_placement.derive_constraints(
        _hand_built(PORT), port_placement.PlacementSpec())
    assert (("T", "a"), ("T", "b")) in hand.chatty
    assert hand.heavy_set == {("T", "h1"), ("T", "h2")}


def test_heavy_cap_equals_reference():
    got = [port_placement.heavy_cap(h, b)
           for h in range(12) for b in range(1, 6)]
    assert got == [ref_placement.heavy_cap(h, b)
                   for h in range(12) for b in range(1, 6)]


@pytest.mark.parametrize("cluster_cpu", [None, 60.0, 400.0])
@pytest.mark.parametrize("seed", range(4))
def test_solutions_and_plans_equal_reference(seed, cluster_cpu):
    """Greedy + seeded local search, the round-robin ablation and whole
    plans (both ``affinity`` settings) over drawn configurations."""
    kw = dict(n_bins=2 + seed % 3, seed=seed, local_moves=64 + 32 * seed)
    sides = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        p = pkg.placement
        spec = p.PlacementSpec(**kw)
        cells = _cells(pkg, 5, size=6, seed0=10 * seed, config_seed=seed)
        cluster = _cluster(pkg, cluster_cpu)
        cons = p.derive_constraints(cells, spec)
        sol = p.solve_placement(cells, spec, cluster)
        rr = p.round_robin_placement(cells, spec, cluster)
        sides[name] = dict(
            sol=_solution(sol), rr=_solution(rr),
            members=sol.bin_members(), heavy=sol.heavy_per_bin(cons),
            mult=sorted(p.interference_multipliers(sol, cons, spec).items()),
            rr_mult=sorted(p.interference_multipliers(rr, cons,
                                                      spec).items()),
            plan=_plan(p.plan_placement(cells, spec, cluster)),
            ablation=_plan(p.plan_placement(
                cells, p.PlacementSpec(affinity=False, **kw), cluster)))
    assert sides["port"] == sides["ref"]
    got = sides["port"]
    n_heavy = sum(got["heavy"])
    assert max(got["heavy"], default=0) <= port_placement.heavy_cap(
        n_heavy, kw["n_bins"])
    assert got["sol"][2] <= got["rr"][2] + 1e-12


def test_scores_of_partial_assignments_equal_reference():
    """``score_placement`` on the greedy pass's partial assignments: only
    the constraints whose endpoints are placed count."""
    for cluster_cpu in (None, 30.0):
        got, want = [], []
        for pkg, out in ((PORT, got), (REF, want)):
            p = pkg.placement
            spec = p.PlacementSpec(n_bins=3)
            cells = _cells(pkg, 4, config_seed=9)
            cons = p.derive_constraints(cells, spec)
            cluster = _cluster(pkg, cluster_cpu) or pkg.engine.ClusterModel()
            demands = p._demands(cells)
            assignment = {}
            for i, key in enumerate(sorted(demands)):
                assignment[key] = (7 * i) % 3
                out.append(p.score_placement(assignment, cons, demands,
                                             cluster, spec))
        assert got == want


def test_multipliers_of_a_given_placement_equal_reference():
    def run(pkg):
        p = pkg.placement
        cons = p.PlacementConstraints(
            chatty=((("A", "p"), ("A", "c")), (("B", "p"), ("B", "c")),
                    (("A", "c"), ("A", "h1"))),
            heavy=(("A", "h1"), ("B", "h2"), ("B", "h3")))
        sol = p.PlacementSolution(
            assignment={("A", "p"): 0, ("A", "c"): 0, ("B", "p"): 0,
                        ("B", "c"): 1, ("A", "h1"): 2, ("B", "h2"): 2,
                        ("B", "h3"): 2},
            n_bins=3, score=0.0, method="affinity")
        spec = p.PlacementSpec(n_bins=3, colocate_bonus=0.1,
                               remote_penalty=0.07,
                               interference_penalty=0.2)
        return (sorted(p.interference_multipliers(sol, cons, spec).items()),
                sol.heavy_per_bin(cons), sol.bin_members(),
                sol.bin_of("B", "c"))
    got = run(PORT)
    assert got == run(REF)
    mult = dict(got[0])
    assert mult[("B", "c")] == 1.07 and ("B", "p") not in mult


def test_scale_cluster_equals_reference():
    for cpu, mem, factor in ((10.0, 1024.0, 4), (110.0, 112640.0, 2.5),
                             (math.inf, math.inf, 3), (7.0, math.inf, 1)):
        got = port_placement.scale_cluster(
            port_engine.ClusterModel(total_cpu=cpu, total_mem_mb=mem), factor)
        want = ref_placement.scale_cluster(
            ref_engine.ClusterModel(total_cpu=cpu, total_mem_mb=mem), factor)
        assert (got.total_cpu, got.total_mem_mb) == (want.total_cpu,
                                                     want.total_mem_mb)
    for factor in (0, 0.5, float("nan")):
        with pytest.raises(ValueError) as port_err:
            port_placement.scale_cluster(port_engine.ClusterModel(), factor)
        with pytest.raises(ValueError) as ref_err:
            ref_placement.scale_cluster(ref_engine.ClusterModel(), factor)
        assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("kw", [dict(n_bins=0), dict(colocate_bonus=1.0),
                                dict(remote_penalty=-0.1),
                                dict(interference_penalty=1.5)])
def test_spec_errors_equal_reference(kw):
    with pytest.raises(ValueError) as port_err:
        port_placement.PlacementSpec(**kw)
    with pytest.raises(ValueError) as ref_err:
        ref_placement.PlacementSpec(**kw)
    assert str(port_err.value) == str(ref_err.value)


def test_duplicate_tenants_raise_the_reference_error():
    def cells(pkg):
        gen, p = pkg.gen, pkg.placement
        return [p.TenantCell(template=gen.chain_workflow(4, seed=1,
                                                         tenant="same"),
                             configs={}),
                p.TenantCell(template=gen.fan_workflow(4, seed=2,
                                                       tenant="same"),
                             configs={}),
                p.TenantCell(template=gen.chain_workflow(3, seed=3,
                                                         tenant="other"),
                             configs={})]
    for call in ("pack_cells", "plan_placement", "solve_placement",
                 "round_robin_placement"):
        errors = []
        for pkg in (PORT, REF):
            p = pkg.placement
            args = () if call == "pack_cells" else (p.PlacementSpec(),)
            with pytest.raises(ValueError) as err:
                getattr(p, call)(cells(pkg), *args)
            errors.append(str(err.value))
        assert errors[0] == errors[1]
        assert "['same']" in errors[0]
    ok = port_placement.pack_cells(cells(PORT)[1:])
    assert [c.tenant for c in ok] == ["same", "other"]
