"""The port's Searcher protocol against the reference's, bit for bit.

AARC, BO and MAFF behind ``make_searcher``, their resumption with an
extra budget, ``retune_state`` and the Input-Aware plugin over
``make_scaled_env``: the same workflows, seeds and budgets go through
both packages, and every ``SearchResult`` field (but the wall clock) and
every sample of every trace must be equal, floats compared with ``==``.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (before repro.serverless: circular import)
from repro.core import input_aware as ref_input_aware
from repro.core import search as ref_search
from repro.serverless import platform as ref_platform
from repro.serverless import workloads as ref_workloads
from repro_torch.core import input_aware as port_input_aware
from repro_torch.core import search as port_search
from repro_torch.serverless import platform as port_platform
from repro_torch.serverless import workloads as port_workloads

from _torch_fleet_parity import assert_same

REF = types.SimpleNamespace(search=ref_search, platform=ref_platform,
                            workloads=ref_workloads,
                            input_aware=ref_input_aware)
PORT = types.SimpleNamespace(search=port_search, platform=port_platform,
                             workloads=port_workloads,
                             input_aware=port_input_aware)

NAMES = sorted(ref_workloads.WORKLOADS)
CASES = {
    "aarc": {}, "aarc-batched": dict(batch_size=8),
    "bo": dict(n_rounds=20, seed=1), "bo-batched": dict(n_rounds=20, seed=1,
                                                        batch_size=4),
    "maff": dict(max_samples=40),
}
RESUME_KWARGS = {"aarc": dict(max_trail=8), "bo": dict(n_rounds=10, seed=0),
                 "maff": dict(max_samples=10)}


def result_view(res):
    """A search result as plain values: every field but the wall clock,
    the trace sample by sample, the best sample, the summary row."""
    fields = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
              if f.name not in ("wall_time_s", "trace", "state", "configs",
                                "best")}
    fields["configs"] = {n: (c.cpu, c.mem) for n, c in res.configs.items()}
    fields["best"] = None if res.best is None else \
        dataclasses.astuple(res.best)
    fields["samples"] = [dataclasses.astuple(s) for s in res.trace.samples]
    summary = res.summary()
    summary.pop("wall_time_s")
    fields["summary"] = summary
    return fields


def search(pkg, method, name, kw, noise=0.0):
    make = (lambda: pkg.platform.make_env(noise_sigma=noise, seed=3))
    searcher = pkg.search.make_searcher(method, make, **kw)
    assert isinstance(searcher, pkg.search.Searcher)
    res = searcher.search(pkg.workloads.WORKLOADS[name](),
                          pkg.workloads.workload_slo(name))
    return searcher, res


@pytest.mark.parametrize("noise", [0.0, 0.025], ids=["analytic", "noisy"])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", list(CASES))
def test_searchers_equal_reference(case, name, noise):
    method = case.split("-")[0]
    _, got = search(PORT, method, name, CASES[case], noise)
    _, want = search(REF, method, name, CASES[case], noise)
    assert got.searcher == method and got.state.searcher == method
    assert_same(result_view(got), result_view(want))


@pytest.mark.parametrize("method", sorted(RESUME_KWARGS))
def test_resume_equals_reference(method):
    """A zero grant is a no-op; an extra budget continues the same trace
    the reference's does, twice in a row."""
    out = []
    for pkg in (PORT, REF):
        searcher, res = search(pkg, method, "ml_pipeline",
                               RESUME_KWARGS[method])
        views = [result_view(res)]
        same = searcher.resume(res.state, 0)
        assert same is res.state.result
        resumed = searcher.resume(res.state, 12)
        views.append(result_view(resumed))
        views.append(result_view(searcher.resume(resumed.state, 12)))
        out.append(views)
    assert_same(out[0], out[1])


@pytest.mark.parametrize("reset", [True, False])
def test_retune_state_equals_reference(reset):
    """Retarget a finished AARC search at a tighter SLO and a heavier
    input mix, re-measure, then resume under the new conditions."""
    out = []
    for pkg in (PORT, REF):
        searcher, res = search(pkg, "aarc", "video_analysis", {})
        spent = pkg.search.retune_state(res.state, slo=0.9 * res.slo,
                                        input_scale=1.2, reset_to_base=reset)
        after = result_view(res.state.result)
        resumed = searcher.resume(res.state, 16)
        out.append((spent, after, result_view(resumed),
                    res.state.env.backend.input_scale))
    assert out[0][0] == 1
    assert_same(out[0], out[1])


def test_registry_and_env_instance_equal_reference():
    """The registry (the resilience searcher registers itself when an
    unknown name first imports it) and an ``Environment`` instance reused
    across searches with its trace reset."""
    with pytest.raises(ValueError) as exc:
        port_search.make_searcher("simulated-annealing",
                                  port_platform.make_env)
    assert str(exc.value) == ("unknown searcher 'simulated-annealing'; "
                              "choose from ['aarc', 'bo', 'maff', "
                              "'resilience']")
    out = []
    for pkg in (PORT, REF):
        env = pkg.platform.make_env()
        searcher = pkg.search.make_searcher("maff", env, max_samples=20)
        views = [result_view(searcher.search(pkg.workloads.WORKLOADS[n](),
                                             pkg.workloads.workload_slo(n)))
                 for n in NAMES]
        infeasible = pkg.search.make_searcher("aarc", env).search(
            pkg.workloads.chatbot(), 1.0)
        views.append(result_view(infeasible))
        out.append(views)
    assert out[0][-1]["note"] and not out[0][-1]["feasible"]
    assert_same(out[0], out[1])


def test_input_aware_engine_equals_reference():
    """Offline profiling per input class over ``make_scaled_env``, then
    classification and dispatch of requests."""
    out = []
    for pkg in (PORT, REF):
        engine = pkg.input_aware.InputAwareEngine(
            pkg.workloads.video_analysis, pkg.platform.make_scaled_env,
            600.0)
        with pytest.raises(RuntimeError):
            engine.dispatch({"scale": 1.0})
        results = engine.profile(batch_size=4)
        rows = {name: (r.critical_path, r.e2e_runtime, r.cost, r.n_samples,
                       {n: (c.cpu, c.mem) for n, c in r.configs.items()})
                for name, r in results.items()}
        picks = [(engine.classify({"scale": s}).name,
                  {n: (c.cpu, c.mem)
                   for n, c in engine.dispatch({"scale": s}).items()})
                 for s in (0.1, 0.5, 0.9, 1.25, 1.6, 3.0)]
        picks.append(engine.classify({}).name)
        out.append(([dataclasses.astuple(c) for c in engine.classes], rows,
                    picks))
    assert set(out[0][1]) == {"light", "middle", "heavy"}
    assert_same(out[0], out[1])
