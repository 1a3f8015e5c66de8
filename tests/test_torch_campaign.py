"""The port's portfolio campaigns against the reference's, bit for bit.

The same ``CampaignSpec`` runs through both packages on the CPU
(``device="cpu"``: every replay's contention-free plane sweeps with the
port's fp64 ``fast_plane_sweep``); ``CampaignReport.to_rows()`` must be
equal but for the wall clock, with floats compared with ``==``, to the
reference's rows on either of its search planes. (The reference's grid
plane misses its own bit-identity contract in the last bit of some
trial costs, ``tests/test_torch_grid_search.py``; on these specs no
row shows it.) The port's grid and sequential planes must agree with
each other too.
"""
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (before repro.serverless: circular import)
from repro.core import campaign as ref_campaign
from repro.core import engine as ref_engine
from repro_torch.core import campaign as port_campaign
from repro_torch.core import engine as port_engine

from _torch_blas import one_blas_thread  # noqa: F401  (autouse)

REF = types.SimpleNamespace(campaign=ref_campaign, engine=ref_engine)
PORT = types.SimpleNamespace(campaign=port_campaign, engine=port_engine)


def _spec(pkg, *, cluster=None, cold_start=None, n_workflows=4, size=6,
          slacks=(1.5, 2.5), searchers=("aarc", "maff"), kwargs=None,
          seed=11, n_instances=8, rate=0.5):
    c = pkg.campaign
    replay = dict(n_instances=n_instances, rate=rate)
    if cluster is not None:
        replay["cluster"] = pkg.engine.ClusterModel(**cluster)
    if cold_start is not None:
        replay["cold_start"] = pkg.engine.ColdStartModel(**cold_start)
    return c.CampaignSpec(
        portfolio=c.PortfolioSpec(n_workflows=n_workflows, size=size,
                                  slo_slacks=slacks),
        replay=c.ReplaySpec(**replay), searchers=searchers,
        searcher_kwargs=(kwargs if kwargs is not None
                         else {"aarc": {"batch_size": 4}}),
        seed=seed)


def _rows(report):
    rows = report.to_rows()
    for row in rows:
        row.pop("wall_time_s")
    return rows


def _summary(report):
    out = report.summary()
    for agg in out.values():
        agg.pop("total_wall_s")
        agg.pop("workflows_per_s")
    return out


CASES = {
    "uniform": {},
    "three-searchers": dict(
        searchers=("aarc", "bo", "maff"),
        kwargs={"aarc": {"batch_size": 4},
                "bo": {"n_rounds": 8, "batch_size": 4}}),
    "finite-cold": dict(cluster=dict(total_cpu=20.0, total_mem_mb=20480.0),
                        cold_start=dict(delay_s=0.5, keep_alive_s=30.0),
                        rate=2.0, n_instances=16),
}


@pytest.mark.parametrize("ref_plane", ["sequential", "grid"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_equal_reference(case, ref_plane):
    kw = CASES[case]
    want = ref_campaign.run_campaign(_spec(REF, **kw),
                                     search_plane=ref_plane)
    got = port_campaign.run_campaign(_spec(PORT, **kw), device="cpu")
    assert _rows(got) == _rows(want)
    assert _summary(got) == _summary(want)
    assert got.totals() == want.totals()
    if case == "finite-cold":
        assert any(r.replay.total_queue_delay_s > 0.0 for r in got.results)


def test_grid_and_sequential_planes_agree():
    spec = _spec(PORT, **CASES["three-searchers"])
    grid = port_campaign.run_campaign(spec, device="cpu")
    seq = port_campaign.run_campaign(spec, device="cpu",
                                     search_plane="sequential")
    assert _rows(grid) == _rows(seq)
    for a, b in zip(grid.results, seq.results):
        assert [s.cost for s in a.search.trace.samples] == \
            [s.cost for s in b.search.trace.samples]


def test_replays_sweep_on_the_given_device(monkeypatch):
    """Every default-spec replay runs one ``fast_plane_sweep`` on the
    campaign's device; the numpy plane gives the same rows."""
    devices = []
    real = port_engine.fast_plane_sweep

    def spy(*args, device=None, **kw):
        devices.append(device)
        return real(*args, device=device, **kw)

    monkeypatch.setattr(port_engine, "fast_plane_sweep", spy)
    spec = _spec(PORT)
    campaign = port_campaign.Campaign(spec, device="cpu")
    report = campaign.run()
    assert devices == ["cpu"] * len(report.results)
    assert campaign._engine.device == "cpu"
    assert campaign._engine.plane_backend == "torch"

    monkeypatch.setattr(port_engine, "fast_plane_sweep", real)
    numpy_plane = port_campaign.Campaign(spec, device="cpu")
    numpy_plane._engine = port_engine.FleetEngine(
        numpy_plane.env_factory().backend, plane_backend="numpy")
    assert _rows(numpy_plane.run()) == _rows(report)


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _spec(PORT, n_workflows=1, slacks=(2.0,), searchers=("maff",))
    # searching alone needs no card
    report = port_campaign.run_campaign(spec, with_replay=False)
    assert all(r.replay is None for r in report.results)
    assert math.isnan(report.summary()["maff"]["mean_slo_attainment"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_campaign.run_campaign(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_campaign.Campaign(spec).run()


def test_tasks_and_arrival_seeds_equal_reference():
    ref = ref_campaign.Campaign(_spec(REF))
    port = port_campaign.Campaign(_spec(PORT), device="cpu")
    view = [(t.index, t.kind, t.wf_seed, t.slo, t.slack, t.n_nodes,
             t.template.identity) for t in port.tasks()]
    assert view == [(t.index, t.kind, t.wf_seed, t.slo, t.slack, t.n_nodes,
                     t.template.identity) for t in ref.tasks()]
    assert port.arrival_seeds(8) == ref.arrival_seeds(8)
    with pytest.raises(ValueError, match="search_plane"):
        port.run(search_plane="bogus")


def test_quickstart_twin_runs_and_matches_reference_quickstart():
    """``examples/torch_quickstart.py`` at its default size on the CPU:
    its search half prints what ``examples/quickstart.py`` prints, and
    its campaign half one line per searcher."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))

    def run(*cmd):
        out = subprocess.run([sys.executable, *cmd], cwd=root, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout.splitlines()

    ref = run("examples/quickstart.py")
    port = run("examples/torch_quickstart.py", "--device", "cpu")
    assert port[:len(ref)] == ref
    tail = port[len(ref):]
    assert tail[1].startswith("campaign: 24 cells")
    assert [line.split()[0] for line in tail[2:]] == ["aarc", "bo", "maff"]
    assert all("attainment 100.0%" in line for line in tail[2:])
