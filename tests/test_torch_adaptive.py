"""The port's adaptive budget campaigns against the reference's.

``AdaptiveReport.to_payload()`` is deterministic (no wall clock), so the
same ``AdaptiveSpec`` through both packages on the CPU
(``device="cpu"``) must give equal payloads, floats compared with
``==``: one grant per round (sequential resumes) and four (the round's
grants resumed together through the lockstep grid runner), on an
infinite cluster, a contended finite one and one with cold starts.
With several grants per round the reference runs its grid runner, and
again with it swapped for its sequential resumes — the plane whose
traces the reference's own contract names (its grid runner misses that
contract in the last bit of some trial costs,
``tests/test_torch_grid_search.py``; on these specs no payload shows
it).
The budget ledger and the accept rule hold in the port as in the
reference's property tests.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (before repro.serverless: circular import)
from repro.core import adaptive as ref_adaptive
from repro.core import campaign as ref_campaign
from repro.core import engine as ref_engine
from repro.core import gridsearch as ref_gridsearch
from repro_torch.core import adaptive as port_adaptive
from repro_torch.core import campaign as port_campaign
from repro_torch.core import engine as port_engine

from _hypothesis_compat import given, settings, st
from _torch_blas import one_blas_thread  # noqa: F401  (autouse)

REF = types.SimpleNamespace(adaptive=ref_adaptive, campaign=ref_campaign,
                            engine=ref_engine)
PORT = types.SimpleNamespace(adaptive=port_adaptive, campaign=port_campaign,
                             engine=port_engine)


REPLAYS = {
    "infinite": dict(n_instances=8, rate=0.5),
    "contended": dict(n_instances=16, rate=0.8,
                      cluster=dict(total_cpu=100.0, total_mem_mb=102400.0)),
    "cold-start": dict(n_instances=16, rate=0.8,
                       cluster=dict(total_cpu=100.0, total_mem_mb=102400.0),
                       cold_start=dict(delay_s=0.4, keep_alive_s=20.0)),
}


def _spec(pkg, replay="infinite", seed=0, total_budget=400, **kw):
    r = dict(REPLAYS[replay])
    if "cluster" in r:
        r["cluster"] = pkg.engine.ClusterModel(**r["cluster"])
    if "cold_start" in r:
        r["cold_start"] = pkg.engine.ColdStartModel(**r["cold_start"])
    base = dict(
        portfolio=pkg.campaign.PortfolioSpec(n_workflows=3, size=6,
                                             slo_slacks=(1.5,)),
        replay=pkg.campaign.ReplaySpec(**r),
        searchers=("aarc", "bo", "maff"),
        seed=seed, total_budget=total_budget, max_rounds=12)
    base.update(kw)
    return pkg.adaptive.AdaptiveSpec(**base)


def _sequential_grid(items):
    """The reference's grid runner, served by sequential resumes."""
    return ref_gridsearch.GridReport(
        results=[it.searcher.resume(it.state, it.extra_budget)
                 for it in items], eligibility=[])


@pytest.mark.parametrize("grants", [1, "4-grid", "4-sequential"])
@pytest.mark.parametrize("replay", sorted(REPLAYS))
def test_payload_equals_reference(replay, grants, monkeypatch):
    if grants == "4-sequential":
        monkeypatch.setattr(ref_adaptive, "run_grid_search",
                            _sequential_grid)
    grants = 1 if grants == 1 else 4
    want = ref_adaptive.run_adaptive(
        _spec(REF, replay, grants_per_round=grants)).to_payload()
    got = port_adaptive.run_adaptive(
        _spec(PORT, replay, grants_per_round=grants),
        device="cpu").to_payload()
    assert got == want
    if replay != "infinite":
        assert got["rounds"] > 0, "contended replay should trigger grants"


def test_grid_grants_equal_sequential_grants(monkeypatch):
    """Four grants per round through the port's grid runner equal the
    same grants resumed one by one."""
    spec = _spec(PORT, "contended", grants_per_round=4)
    grid = port_adaptive.run_adaptive(spec, device="cpu").to_payload()

    def sequential(items):
        return types.SimpleNamespace(results=[
            it.searcher.resume(it.state, it.extra_budget) for it in items])

    monkeypatch.setattr(port_adaptive, "run_grid_search", sequential)
    assert port_adaptive.run_adaptive(spec, device="cpu").to_payload() == grid


@given(st.integers(0, 10_000), st.integers(10, 900), st.integers(2, 10))
@settings(max_examples=5, deadline=None)
def test_budget_ledger_is_conserved(seed, total_budget, round_budget):
    report = port_adaptive.run_adaptive(
        _spec(PORT, seed=seed, total_budget=total_budget,
              round_budget=round_budget), device="cpu")
    b = report.budget
    assert b["total"] == b["spent"] + b["remaining"]
    assert b["spent"] == sum(c.spent for c in report.cells)
    assert b["total"] == report.spec.total_budget


def test_attainment_is_monotone_and_grants_bounded():
    spec = _spec(PORT, "contended", round_budget=7, max_rounds=20,
                 grants_per_round=4)
    report = port_adaptive.run_adaptive(spec, device="cpu")
    assert report.rounds > 0
    base = port_adaptive.run_adaptive(dataclasses.replace(spec, max_rounds=0),
                                      device="cpu")
    for cell, cold in zip(report.cells, base.cells):
        hist = cell.history
        assert all(b >= a - 1e-12 for a, b in zip(hist, hist[1:]))
        assert cell.attainment == hist[-1]
        assert cell.spent - cold.spent <= cell.grants * spec.round_budget


def test_warm_sources_and_unseeded_cells():
    report = port_adaptive.run_adaptive(_spec(PORT, total_budget=2000),
                                        device="cpu")
    by = report.by_searcher()
    assert all(c.warm_source == "" for c in by["aarc"])
    assert all(c.warm_source == "aarc-trace" for c in by["bo"])
    assert all(c.warm_source == "aarc-best" for c in by["maff"])
    tiny = port_adaptive.run_adaptive(_spec(PORT, total_budget=25),
                                      device="cpu")
    unseeded = [c for c in tiny.cells if c.result is None]
    assert unseeded and all(c.exhausted for c in unseeded)


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_adaptive.run_adaptive(_spec(PORT))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_adaptive.AdaptiveCampaign(_spec(PORT)).run()
