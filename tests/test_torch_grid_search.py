"""The port's lockstep grid runner against the reference, bit for bit.

The reference's own contract (``src/repro/core/gridsearch.py``) is that
a cell's grid trace equals its sequential ``Searcher.search`` /
``resume`` trace bit for bit. The reference misses it in the last bit
of some trial costs: its fused commit prices a trial with a left fold,
while the sequential path's ``workflow_cost`` is the builtin ``sum``,
which is compensated on Python 3.12. The port's ``_vec_cost`` sums as
``sum`` does, so here:

  * the port's grid traces equal the **reference's sequential** traces
    (every field, ``cost`` included) and the port's own sequential
    traces, at sigma 0 and 0.05, for every searcher, fresh and resumed;
  * every field but ``cost`` equals the reference's grid runner, and so
    do its rounds, fused evaluations, eligibility and the backends'
    invocation counters;
  * ``_vec_cost`` equals ``workflow_cost`` on random terms, and a plain
    left fold does not, in the last bit, on one fixed cell.
"""
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (before repro.serverless: circular import)
from repro.core import campaign as ref_campaign
from repro.core import priority as ref_priority
from repro.core import resources as ref_resources
from repro.core import search as ref_search
from repro.serverless import generator as ref_generator
from repro.serverless import platform as ref_platform
from repro_torch.core import campaign as port_campaign
from repro_torch.core import cost as port_cost
from repro_torch.core import env as port_env
from repro_torch.core import gridsearch as port_gridsearch
from repro_torch.core import priority as port_priority
from repro_torch.core import resources as port_resources
from repro_torch.core import search as port_search
from repro_torch.serverless import generator as port_generator
from repro_torch.serverless import platform as port_platform

from _hypothesis_compat import given, settings, st
from _torch_blas import one_blas_thread  # noqa: F401  (autouse)

REF = types.SimpleNamespace(campaign=ref_campaign, search=ref_search,
                            generator=ref_generator, platform=ref_platform,
                            priority=ref_priority, resources=ref_resources)
PORT = types.SimpleNamespace(campaign=port_campaign, search=port_search,
                             generator=port_generator, platform=port_platform,
                             priority=port_priority, resources=port_resources)


KINDS = ("chain", "fan", "diamond", "layered")
SEARCHER_KWARGS = {"aarc": {"batch_size": 4},
                   "bo": {"n_rounds": 6, "n_init": 8, "batch_size": 4},
                   "maff": {}}
SIGMAS = pytest.mark.parametrize("sigma", [0.0, 0.05],
                                 ids=["analytic", "stochastic"])


def _key(sample, with_cost=True):
    return (sample.e2e_runtime, sample.cost if with_cost else None,
            sample.feasible, sample.error, sample.trial_time, sample.note,
            tuple(sample.config_items or ()))


def _traces(results, with_cost=True):
    return [[_key(s, with_cost) for s in res.trace.samples]
            for res in results]


def _make_cell(pkg, kind, sname, sigma, slack, seed):
    wf = pkg.campaign._build_workflow(kind, 8, seed)
    env = pkg.platform.make_env(noise_sigma=sigma, seed=1000 + seed)
    searcher = pkg.search.make_searcher(sname, lambda e=env: e,
                                        **SEARCHER_KWARGS[sname])
    return env, searcher, wf, pkg.generator.suggest_slo(wf, slack=slack)


def _grid_specs(sigma):
    specs = []
    for kind, sname, slack in itertools.product(
            KINDS, sorted(SEARCHER_KWARGS), [1.05, 2.0]):
        specs.append((kind, sname, sigma, slack, 7))
        if kind == "chain" and slack == 1.05:
            specs.append((kind, sname, sigma, slack, 7))
            specs.append((kind, sname, sigma, slack, 11))
    return specs


def _sequential(pkg, specs):
    results, invocations = [], []
    for spec in specs:
        env, searcher, wf, slo = _make_cell(pkg, *spec)
        results.append(searcher.search(wf, slo))
        invocations.append(env.backend.invocations)
    return results, invocations


def _grid(pkg, specs):
    envs, cells = [], []
    for spec in specs:
        env, searcher, wf, slo = _make_cell(pkg, *spec)
        envs.append(env)
        cells.append((searcher, wf, slo))
    report = pkg.search.run_grid_search(cells)
    return report, [env.backend.invocations for env in envs]


@SIGMAS
def test_grid_traces_equal_reference_sequential(sigma):
    specs = _grid_specs(sigma)
    ref_results, ref_inv = _sequential(REF, specs)
    # tight slack must exercise the fused failure branches
    assert any(k[3] for trace in _traces(ref_results) for k in trace)
    report, inv = _grid(PORT, specs)
    assert report.serialized_cells == 0
    assert report.fused_evaluations > 0
    assert _traces(report.results) == _traces(ref_results)
    assert inv == ref_inv
    for got, want in zip(report.results, ref_results):
        assert got.cost == want.cost and got.search_cost == want.search_cost
        assert got.n_samples == want.n_samples


@SIGMAS
def test_grid_traces_bit_identical_to_sequential(sigma):
    specs = _grid_specs(sigma)
    seq_results, seq_inv = _sequential(PORT, specs)
    report, inv = _grid(PORT, specs)
    assert report.serialized_cells == 0
    assert all(e.eligible for e in report.eligibility)
    assert report.fused_evaluations > 0
    for i, res in enumerate(report.results):
        assert _traces([res]) == _traces([seq_results[i]]), \
            f"trace diverged for cell {specs[i]}"
    assert inv == seq_inv


@SIGMAS
def test_grid_matches_reference_grid_but_cost(sigma):
    specs = _grid_specs(sigma)
    ref_report, ref_inv = _grid(REF, specs)
    report, inv = _grid(PORT, specs)
    assert _traces(report.results, with_cost=False) == \
        _traces(ref_report.results, with_cost=False)
    assert (report.rounds, report.fused_evaluations,
            report.serialized_cells) == \
        (ref_report.rounds, ref_report.fused_evaluations,
         ref_report.serialized_cells)
    assert [(e.index, e.searcher, e.workflow, e.eligible, e.fusable,
             e.reasons) for e in report.eligibility] == \
        [(e.index, e.searcher, e.workflow, e.eligible, e.fusable,
          e.reasons) for e in ref_report.eligibility]
    assert inv == ref_inv


@SIGMAS
def test_grid_resume_equals_reference_sequential(sigma):
    """Fresh grid searches, then one grid of ``GridResume`` grants, all
    fused: every cell equals the reference's ``search`` + ``resume``."""
    extra = 8
    specs = [(kind, sname, sigma, 1.2, seed)
             for sname in sorted(SEARCHER_KWARGS)
             for kind, seed in (("chain", 7), ("chain", 8), ("fan", 7))]
    ref_results, ref_inv = [], []
    for spec in specs:
        env, searcher, wf, slo = _make_cell(REF, *spec)
        ref_results.append(searcher.resume(searcher.search(wf, slo).state,
                                           extra))
        ref_inv.append(env.backend.invocations)

    envs, cells = [], []
    for spec in specs:
        env, searcher, wf, slo = _make_cell(PORT, *spec)
        envs.append(env)
        cells.append((searcher, wf, slo))
    first = port_search.run_grid_search(cells).results
    report = port_search.run_grid_search(
        [port_search.GridResume(searcher=cell[0], state=res.state,
                                extra_budget=extra)
         for cell, res in zip(cells, first)])
    assert report.fused_evaluations > 0
    assert _traces(report.results) == _traces(ref_results)
    assert [env.backend.invocations for env in envs] == ref_inv


class _OpaqueSearcher:
    """A searcher without ``plan()`` — no lockstep support."""

    name = "opaque"

    def __init__(self, inner):
        self._inner = inner

    def search(self, wf, slo):
        return self._inner.search(wf, slo)


def _mixed_cells(pkg):
    make = pkg.search.make_searcher
    env_a, searcher_a, wf_a, slo_a = _make_cell(pkg, "chain", "maff", 0.0,
                                                1.2, 7)
    _, searcher_b, wf_b, slo_b = _make_cell(pkg, "fan", "maff", 0.0, 1.2, 8)
    shared_env, _, _, _ = _make_cell(pkg, "chain", "maff", 0.0, 1.2, 9)
    shared_1 = make("maff", lambda: shared_env)
    shared_2 = make("maff", lambda: shared_env)
    wf_s1 = pkg.campaign._build_workflow("chain", 8, 9)
    wf_s2 = pkg.campaign._build_workflow("chain", 8, 10)
    env_o, _, wf_o, slo_o = _make_cell(pkg, "diamond", "maff", 0.0, 1.2, 11)
    opaque = _OpaqueSearcher(make("maff", lambda e=env_o: e))
    slo = pkg.generator.suggest_slo
    cells = [
        (searcher_a, wf_a, slo_a),
        (shared_1, wf_s1, slo(wf_s1, slack=1.2)),
        (shared_2, wf_s2, slo(wf_s2, slack=1.2)),
        pkg.search.GridCell(searcher=opaque, wf=wf_o, slo=slo_o),
        (searcher_b, wf_b, slo_b),
    ]
    return env_a, cells


def _eligibility_view(rows):
    return [(e.index, e.searcher, e.workflow, e.eligible, e.fusable,
             e.reasons) for e in rows]


def test_mixed_eligibility_serializes_with_reference_reasons():
    ref_env, ref_cells = _mixed_cells(REF)
    env_a, cells = _mixed_cells(PORT)

    dry = port_search.grid_eligibility(cells)
    assert [e.eligible for e in dry] == [True, False, False, False, True]
    assert env_a.backend.invocations == 0      # the dry run samples nothing
    assert _eligibility_view(dry) == \
        _eligibility_view(ref_search.grid_eligibility(ref_cells))

    report = port_search.run_grid_search(cells)
    ref_report = ref_search.run_grid_search(ref_cells)
    assert report.serialized_cells == ref_report.serialized_cells == 3
    assert _eligibility_view(report.eligibility) == \
        _eligibility_view(ref_report.eligibility)
    assert any("Environment" in r for r in report.eligibility[1].reasons)
    assert any("plan" in r for r in report.eligibility[3].reasons)
    # serialized cells return their plain sequential result; fused ones
    # the reference's sequential trace
    ref_seq = [c[0].search(c[1], c[2]) if isinstance(c, tuple)
               else c.searcher.search(c.wf, c.slo)
               for c in _mixed_cells(REF)[1]]
    assert _traces(report.results) == _traces(ref_seq)
    assert env_a.backend.invocations == ref_env.backend.invocations


def test_priority_crossover_matches_probe_path_and_reference():
    """Narrow rounds served by scalar invokes (the batch-size crossover)
    commit the trial sequence the batched probe path would, in both
    packages alike."""
    def run(pkg, scalar_round_max):
        wf = pkg.campaign._build_workflow("layered", 12, 3)
        env = pkg.platform.make_env(seed=42)
        if scalar_round_max is not None:
            env.backend.scalar_round_max = scalar_round_max
        for node in wf:
            node.config = pkg.resources.BASE_CONFIG.copy()
        wf.execute(env.oracle)
        path = [node.name for node in wf]
        slo = pkg.generator.suggest_slo(wf, slack=1.3)
        pkg.priority.priority_configuration(wf, path, slo, env, batch_size=8)
        return [_key(s) for s in env.trace.samples], env.backend.invocations

    port_default = run(PORT, None)
    assert port_default == run(PORT, 0)        # backend default vs probe-only
    assert port_default == run(REF, None)


# -- the fused-grid contract and the counters --------------------------

def test_fusion_contract_and_counters_match_reference():
    for pkg in (REF, PORT):
        analytic = pkg.platform.AnalyticBackend(input_scale=2.0)
        assert analytic.grid_fusion_key() == ("analytic-surface", 2.0)
        stochastic = pkg.platform.StochasticBackend(noise_sigma=0.05, seed=1)
        assert stochastic.grid_fusion_key() == ("analytic-surface", 1.0)

        class Custom(pkg.platform.AnalyticBackend):
            def invoke_batch(self, nodes):
                return super().invoke_batch(nodes)

        assert Custom().grid_fusion_key() is None

    def counts(pkg):
        plat = pkg.platform.SimulatedPlatform(noise_sigma=0.05, seed=3)
        wf = pkg.campaign._build_workflow("fan", 8, 4)
        nodes = list(wf)
        out = [plat.oracle(nodes[0]), plat.clamped_oracle(nodes[1])]
        rt, failed = plat.backend.invoke_batch(nodes)
        out += [rt.tolist(), failed.tolist(), plat.invocations]
        cpu = np.full((3, len(nodes)), 1.5)
        mem = np.full((3, len(nodes)), 512.0)
        tables = plat.backend.surface_tables(nodes)
        probe = plat.backend.surface_probe(cpu[0], mem[0], tables)
        out += [probe[0].tolist(), probe[1].tolist(), plat.invocations,
                plat.backend.surface_floor(tables).tolist()]
        noisy = plat.backend.apply_invocation_noise(probe[0], ~probe[1])
        out += [noisy.tolist(), plat.invocations]
        rt, failed = plat.backend.invoke_config_batch(nodes, cpu, mem)
        out += [rt.tolist(), plat.invocations]
        plat.backend.config_surface(nodes, cpu, mem)
        out.append(plat.invocations)
        return out

    assert counts(PORT) == counts(REF)


# -- the summation repair ----------------------------------------------

class _Term:
    def __init__(self, runtime, config):
        self.runtime = runtime
        self.config = config


@st.composite
def _cost_case(draw):
    g = draw(st.integers(1, 6))
    n = draw(st.integers(1, 64))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    # runtimes spanning milliseconds to hours, cpu and mem on the lattice
    rts = 10.0 ** rng.uniform(-3.0, 4.0, size=(g, n))
    cpu = rng.integers(1, 101, size=(g, n)) * port_resources.CPU_STEP
    mem = rng.integers(2, 161, size=(g, n)) * port_resources.MEM_STEP_MB
    return rts, cpu, mem


@given(_cost_case())
@settings(max_examples=25, deadline=None)
def test_vec_cost_equals_workflow_cost(case):
    rts, cpu, mem = case
    pricing = port_cost.DEFAULT_PRICING
    got = port_gridsearch._vec_cost(pricing, rts, cpu, mem)
    for gi in range(rts.shape[0]):
        # the terms the sequential path feeds ``sum``: Python floats
        terms = [_Term(float(r), port_resources.ResourceConfig(
            cpu=float(c), mem=float(m)))
            for r, c, m in zip(rts[gi], cpu[gi], mem[gi])]
        want = port_cost.workflow_cost(pricing, terms)
        assert got[gi] == want, (gi, got[gi], want)


def test_sequential_trials_sum_exact_python_floats(monkeypatch):
    """The element types the trial path hands ``sum``: every
    ``function_cost`` term is an exact ``float`` (compensated by
    CPython 3.12), never an ``np.float64`` (which ``sum`` would add
    uncompensated)."""
    seen = set()
    real = port_env.workflow_cost

    def spy(pricing, nodes):
        for n in nodes:
            seen.add(type(pricing.function_cost(n.runtime, n.config)))
            seen.add(type(n.runtime))
            seen.add(type(n.config.cpu))
            seen.add(type(n.config.mem))
        return real(pricing, nodes)

    monkeypatch.setattr(port_env, "workflow_cost", spy)
    for spec in _grid_specs(0.05)[:9]:
        env, searcher, wf, slo = _make_cell(PORT, *spec)
        searcher.search(wf, slo)
    assert seen == {float}


def test_left_fold_misses_workflow_cost_in_the_last_bit(monkeypatch):
    """The fixed case behind the reference's failure: the chain cell
    (aarc, slack 1.05, seed 7) and its structure group. A plain left
    fold of the same terms differs from ``_vec_cost`` (and so from the
    sequential ``workflow_cost``) in the last bits of some trial
    commits: one ulp at least once, never more than a few."""
    captured = []
    real = port_gridsearch._vec_cost

    def spy(pricing, rts, cpu, mem):
        out = real(pricing, rts, cpu, mem)
        captured.append((rts.copy(), cpu.copy(), mem.copy(), out))
        return out

    monkeypatch.setattr(port_gridsearch, "_vec_cost", spy)
    specs = [s for s in _grid_specs(0.0)
             if s[0] == "chain" and s[1] == "aarc"]
    assert specs[0] == ("chain", "aarc", 0.0, 1.05, 7)
    report, _ = _grid(PORT, specs)
    seq, _ = _sequential(PORT, specs)
    assert _traces(report.results) == _traces(seq)
    assert captured, "the structure group must take the vectorized commit"

    pricing = port_cost.DEFAULT_PRICING
    diffs = []
    for rts, cpu, mem, out in captured:
        contrib = rts * (pricing.mu0 * cpu + pricing.mu1 * mem) + pricing.mu2
        fold = np.add.accumulate(contrib, axis=1)[:, -1]
        for gi in np.flatnonzero(fold != out):
            diffs.append((float(fold[gi]), float(out[gi])))
    assert diffs, "a left fold should miss the compensated sum somewhere"
    ulps = [abs(fold - comp) / np.spacing(comp) for fold, comp in diffs]
    assert 1.0 in ulps
    assert max(ulps) <= 4.0
