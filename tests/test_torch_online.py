"""The port's online control plane against the reference's, bit for bit.

The same ``OnlineSpec`` runs through both packages on the CPU (the port
with ``device="cpu"``, so that every contention-free replay sweeps with
its fp64 ``fast_plane_sweep``) and ``OnlineReport.to_payload()`` must be
equal, floats compared with ``==``: the scenarios of
``benchmarks/online_serving.py`` under each control mode, the baseline,
packed and round-robin runs of ``benchmarks/placement.py``, the four
actuator sets of ``benchmarks/autoscale.py``, live faults with the
recovery actuator, and a stochastic environment. Each spec is built per
package from the benchmarks' numbers; the port's side imports nothing
from ``benchmarks/``.

The deploy step searches every cell on the grid runner. The reference's
grid sums trial commits left to right where its sequential search (and
the port's grid) sums as Python's ``sum`` does, so a deploy trace's
``cost`` can differ from the reference's in the last bit. No payload
shows it; one test shows the cause by serving the reference's deploy
sequentially.
"""
import dataclasses
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (before repro.serverless: circular import)
from repro.core import autoscale as ref_autoscale
from repro.core import campaign as ref_campaign
from repro.core import engine as ref_engine
from repro.core import faults as ref_faults
from repro.core import online as ref_online
from repro.core import placement as ref_placement
from repro.serverless import generator as ref_gen
from repro.serverless import platform as ref_platform
from repro_torch.core import autoscale as port_autoscale
from repro_torch.core import campaign as port_campaign
from repro_torch.core import engine as port_engine
from repro_torch.core import faults as port_faults
from repro_torch.core import online as port_online
from repro_torch.core import placement as port_placement
from repro_torch.serverless import generator as port_gen
from repro_torch.serverless import platform as port_platform

from _torch_blas import one_blas_thread  # noqa: F401  (autouse)

REF = types.SimpleNamespace(
    autoscale=ref_autoscale, campaign=ref_campaign, engine=ref_engine,
    faults=ref_faults, online=ref_online, placement=ref_placement,
    gen=ref_gen, platform=ref_platform)
PORT = types.SimpleNamespace(
    autoscale=port_autoscale, campaign=port_campaign, engine=port_engine,
    faults=port_faults, online=port_online, placement=port_placement,
    gen=port_gen, platform=port_platform)

MODES = ("drift", "never", "every_epoch")


def _serving_specs(pkg):
    """``benchmarks/online_serving.py:68-103``."""
    c, e, g, o = pkg.campaign, pkg.engine, pkg.gen, pkg.online
    load_shift = o.OnlineSpec(
        portfolio=c.PortfolioSpec(n_workflows=4, size=6, kinds=("chain",),
                                  slo_slacks=(1.6,)),
        replay=c.ReplaySpec(n_instances=24, rate=0.1,
                            cluster=e.ClusterModel(
                                total_cpu=460.0,
                                total_mem_mb=460.0 * 1024.0)),
        n_epochs=12, drift=g.load_shift_schedule(2, 3.0), seed=0,
        total_budget=512)
    return {
        "load_shift": load_shift,
        "input_mix": o.OnlineSpec(
            portfolio=c.PortfolioSpec(n_workflows=3, size=6,
                                      slo_slacks=(2.0,)),
            replay=c.ReplaySpec(n_instances=24, rate=0.5),
            n_epochs=10, drift=g.input_mix_schedule(2, 1.5), seed=0,
            total_budget=512),
        "cold_start": o.OnlineSpec(
            portfolio=c.PortfolioSpec(n_workflows=3, size=6,
                                      kinds=("chain",), slo_slacks=(1.4,)),
            replay=c.ReplaySpec(n_instances=24, rate=0.05,
                                cold_start=e.ColdStartModel(
                                    delay_s=1.0, keep_alive_s=600.0)),
            n_epochs=10, drift=g.coldstart_schedule(2, 5.0, keep_alive_s=5.0),
            seed=0, total_budget=512),
        "no_drift": dataclasses.replace(load_shift, drift=g.DriftSchedule(),
                                        n_epochs=6),
    }


def _placement_specs(pkg):
    """``benchmarks/placement.py:50-73`` and its three runs per scenario
    (``placement_case``), and the packed load shift under drift control,
    whose challengers validate inside the packed cluster."""
    c, e, g, o, p = (pkg.campaign, pkg.engine, pkg.gen, pkg.online,
                     pkg.placement)
    cluster = e.ClusterModel(total_cpu=110.0, total_mem_mb=110.0 * 1024.0)
    scenarios = {
        "load_shift": o.OnlineSpec(
            portfolio=c.PortfolioSpec(n_workflows=4, size=6,
                                      kinds=("chain",), slo_slacks=(1.6,)),
            replay=c.ReplaySpec(n_instances=16, rate=0.1, cluster=cluster),
            n_epochs=8, drift=g.load_shift_schedule(2, 3.0), seed=0,
            mode="never"),
        "input_mix": o.OnlineSpec(
            portfolio=c.PortfolioSpec(n_workflows=4, size=6,
                                      kinds=("chain", "fan"),
                                      slo_slacks=(2.0,)),
            replay=c.ReplaySpec(n_instances=16, rate=0.25, cluster=cluster),
            n_epochs=8, drift=g.input_mix_schedule(2, 1.5), seed=0,
            mode="never")}
    placement = p.PlacementSpec(n_bins=4)
    out = {}
    for name, spec in scenarios.items():
        out[f"{name}-baseline"] = spec
        out[f"{name}-packed"] = dataclasses.replace(spec, placement=placement)
        out[f"{name}-ablation"] = dataclasses.replace(
            spec, placement=dataclasses.replace(placement, affinity=False))
    out["load_shift-packed-drift"] = dataclasses.replace(
        out["load_shift-packed"], mode="drift")
    return out


def _autoscale_specs(pkg):
    """``benchmarks/autoscale.py:80-104``: the static fleet and the three
    actuator sets (``autoscale_case``)."""
    a, c, e, g, o = (pkg.autoscale, pkg.campaign, pkg.engine, pkg.gen,
                     pkg.online)
    compound = o.OnlineSpec(
        portfolio=c.PortfolioSpec(n_workflows=2, size=5, kinds=("chain",),
                                  slo_slacks=(1.6,)),
        replay=c.ReplaySpec(n_instances=16, rate=0.015,
                            cluster=e.ClusterModel(total_cpu=60.0,
                                                   total_mem_mb=61440.0)),
        n_epochs=14,
        drift=g.DriftSchedule((g.DriftEvent(4, "load", 3.0),
                               g.DriftEvent(4, "input", 1.3))),
        seed=0, total_budget=768, cooldown_epochs=0,
        autoscale=a.AutoscaleSpec(provision_floor=0.02, max_replicas=12,
                                  max_cluster_scale=6.0))
    out = {"static": dataclasses.replace(compound, mode="never")}
    for name, actuators in (("joint", ("config", "scale")),
                            ("config_only", ("config",)),
                            ("scale_only", ("scale",))):
        out[name] = dataclasses.replace(
            compound, autoscale=dataclasses.replace(compound.autoscale,
                                                    actuators=actuators))
    return out


def _fault_specs(pkg):
    """``tests/test_faults.py::_online_fault_spec`` (live transients and
    stragglers, the recovery actuator), then the same faults without it,
    and with it on replica pools of a finite cluster."""
    c, f, o = pkg.campaign, pkg.faults, pkg.online
    faults = f.FaultModel(default_transient=0.15, straggler_prob=0.1,
                          straggler_factor=5.0, seed=11)
    base = o.OnlineSpec(
        portfolio=c.PortfolioSpec(n_workflows=2, size=6, slo_slacks=(2.0,)),
        replay=c.ReplaySpec(n_instances=16, rate=0.5),
        n_epochs=4, seed=0, total_budget=256, faults=faults,
        resilience=f.ResilienceSpec(faults=faults))
    return {
        "resilience": base,
        "faults-only": dataclasses.replace(base, resilience=None),
        "resilience-pools": dataclasses.replace(
            base, drift=pkg.gen.input_mix_schedule(2, 1.5),
            replay=c.ReplaySpec(n_instances=16, rate=0.2,
                                cluster=pkg.engine.ClusterModel(
                                    total_cpu=80.0, total_mem_mb=81920.0)),
            autoscale=pkg.autoscale.AutoscaleSpec(provision_floor=0.02,
                                                  max_replicas=6)),
    }


def _stochastic_spec(pkg):
    """A small input-mix spec; its environments draw noise
    (``tests/test_replay_batch.py``'s factory)."""
    c, o = pkg.campaign, pkg.online
    return o.OnlineSpec(
        portfolio=c.PortfolioSpec(n_workflows=2, size=5, slo_slacks=(2.0,)),
        replay=c.ReplaySpec(n_instances=12, rate=0.5), n_epochs=4,
        drift=pkg.gen.input_mix_schedule(1, 1.5), seed=3, total_budget=128)


SPECS = {**{f"serving-{k}": (lambda pkg, k=k: _serving_specs(pkg)[k])
            for k in ("load_shift", "input_mix", "cold_start", "no_drift")},
         **{f"placement-{k}": (lambda pkg, k=k: _placement_specs(pkg)[k])
            for k in ("load_shift-baseline", "load_shift-packed",
                      "load_shift-ablation", "input_mix-baseline",
                      "input_mix-packed", "input_mix-ablation",
                      "load_shift-packed-drift")},
         **{f"autoscale-{k}": (lambda pkg, k=k: _autoscale_specs(pkg)[k])
            for k in ("static", "joint", "config_only", "scale_only")},
         **{f"faults-{k}": (lambda pkg, k=k: _fault_specs(pkg)[k])
            for k in ("resilience", "faults-only", "resilience-pools")}}


@functools.lru_cache(maxsize=None)
def _report(side: str, name: str, mode=None):
    """``run_online`` of a named spec, once per side and mode: the gate
    test reads the runs the payload tests made."""
    pkg = PORT if side == "port" else REF
    spec = SPECS[name](pkg)
    if mode is not None:
        spec = dataclasses.replace(spec, mode=mode)
    if side == "port":
        return port_online.run_online(spec, device="cpu")
    return ref_online.run_online(spec)


def _assert_payload_equal(name, mode=None):
    got = _report("port", name, mode).to_payload()
    want = _report("ref", name, mode).to_payload()
    assert got == want
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["load_shift", "input_mix", "cold_start",
                                  "no_drift"])
def test_serving_payload_equals_reference(case, mode):
    got = _assert_payload_equal(f"serving-{case}", mode)
    if mode == "drift" and case != "no_drift":
        assert got["reconfigs"], "drift should earn grants"


@pytest.mark.parametrize("case", ["load_shift-baseline", "load_shift-packed",
                                  "load_shift-ablation", "input_mix-baseline",
                                  "input_mix-packed", "input_mix-ablation",
                                  "load_shift-packed-drift"])
def test_placement_payload_equals_reference(case):
    got = _assert_payload_equal(f"placement-{case}")
    assert ("placement" in got) == ("baseline" not in case)


@pytest.mark.parametrize("variant", ["static", "joint", "config_only",
                                     "scale_only"])
def test_autoscale_payload_equals_reference(variant):
    got = _assert_payload_equal(f"autoscale-{variant}")
    assert all("replicas" in cell for cell in got["cells"])


@pytest.mark.parametrize("case", ["resilience", "faults-only",
                                  "resilience-pools"])
def test_faults_payload_equals_reference(case):
    got = _assert_payload_equal(f"faults-{case}")
    assert any(row["fault_failures"] > 0 for row in got["epochs"])
    assert ("policy_levels" in got["cells"][0]) == (case != "faults-only")


@pytest.mark.parametrize("mode", ["drift", "every_epoch"])
def test_stochastic_env_factory_payload_equals_reference(mode):
    got = port_online.run_online(
        dataclasses.replace(_stochastic_spec(PORT), mode=mode),
        env_factory=lambda: port_platform.make_env(noise_sigma=0.05,
                                                   seed=17),
        device="cpu").to_payload()
    want = ref_online.run_online(
        dataclasses.replace(_stochastic_spec(REF), mode=mode),
        env_factory=lambda: ref_platform.make_env(noise_sigma=0.05,
                                                  seed=17)).to_payload()
    assert got == want


def test_benchmark_gates_equal_reference():
    """``chip_smoke.py``'s copies of the three benchmarks' gate numbers,
    on the port's runs, equal the benchmarks' own rows on the
    reference's."""
    chip_smoke = pytest.importorskip("chip_smoke")
    online_bench = pytest.importorskip("benchmarks.online_serving")
    placement_bench = pytest.importorskip("benchmarks.placement")
    autoscale_bench = pytest.importorskip("benchmarks.autoscale")
    specs = _serving_specs(PORT)
    for case in ("load_shift", "input_mix"):
        got = chip_smoke.drift_gates(
            specs[case], *(_report("port", f"serving-{case}", mode)
                           for mode in MODES))
        want = online_bench.drift_case(case, getattr(online_bench,
                                                     case.upper()))
        assert got == {k: want[k] for k in got}
    want = online_bench.no_drift_case("no_drift", online_bench.NO_DRIFT)
    assert chip_smoke.no_drift_identical(
        _report("port", "serving-no_drift", "drift"),
        _report("port", "serving-no_drift", "never")) \
        == want["bit_identical"] is True
    for case in ("load_shift", "input_mix"):
        got = chip_smoke.placement_gates(
            *(_report("port", f"placement-{case}-{name}")
              for name in ("baseline", "packed", "ablation")))
        want = placement_bench.placement_case(case, getattr(placement_bench,
                                                            case.upper()))
        assert got == {k: want[k] for k in got}
    got = chip_smoke.autoscale_gates(
        _autoscale_specs(PORT)["static"], _report("port", "autoscale-static"),
        {name: _report("port", f"autoscale-{name}")
         for name in ("joint", "config_only", "scale_only")})
    want = autoscale_bench.autoscale_case("compound_shift",
                                          autoscale_bench.COMPOUND_SHIFT)
    assert got == {k: want[k] for k in got}
    assert chip_smoke.POST_EPOCHS == online_bench.POST_EPOCHS \
        == autoscale_bench.POST_EPOCHS
    assert chip_smoke.SETTLE_EPOCHS == autoscale_bench.SETTLE_EPOCHS
    assert (chip_smoke.RECOVERY_BAR, chip_smoke.BUDGET_BAR) == (
        online_bench.RECOVERY_BAR, online_bench.BUDGET_BAR)
    assert chip_smoke.AUTOSCALE_RECOVERY_BAR \
        == autoscale_bench.RECOVERY_BAR_JOINT \
        == autoscale_bench.RECOVERY_BAR_ABLATION


def _deploy_traces(report):
    return [[dataclasses.astuple(s) for s in cell.result.trace.samples]
            for cell in report.cells]


def test_deploy_traces_equal_reference_deployed_sequentially(monkeypatch):
    """The port's deploy traces (its grid sums trial commits as the
    sequential search does) equal the reference's when the reference
    searches each cell sequentially, and differ from its grid's only in
    the last bit of trial costs; the payloads are equal either way."""
    name = "serving-load_shift"
    spec = dataclasses.replace(SPECS[name](REF), n_epochs=1, mode="never")
    port_spec = dataclasses.replace(SPECS[name](PORT), n_epochs=1,
                                    mode="never")
    port = port_online.run_online(port_spec, device="cpu")
    grid = ref_online.run_online(spec)

    def sequential(cells):
        return types.SimpleNamespace(
            results=[c.searcher.search(c.wf, c.slo) for c in cells])

    monkeypatch.setattr(ref_online, "run_grid_search", sequential)
    seq = ref_online.run_online(spec)
    assert _deploy_traces(port) == _deploy_traces(seq)
    assert port.to_payload() == seq.to_payload() == grid.to_payload()
    # where the reference's grid trace differs, it is a trial cost's last
    # bit and nothing else
    diffs = [(a, b) for pc, gc in zip(_deploy_traces(port),
                                      _deploy_traces(grid))
             for a, b in zip(pc, gc) if a != b]
    assert diffs, "the reference's grid sums left to right on this spec"
    for a, b in diffs:
        fields = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        assert fields == [2]                          # Sample.cost
        assert abs(a[2] - b[2]) <= 2 * abs(a[2]) * 2.0 ** -52


def test_spec_errors_equal_reference():
    cases = (dict(mode="sometimes"), dict(grant_budget=1),
             dict(resilience="faults"))
    for kw in cases:
        errors = []
        for pkg in (PORT, REF):
            if kw.get("resilience") == "faults":
                kw = dict(resilience=pkg.faults.ResilienceSpec())
            with pytest.raises(ValueError) as err:
                pkg.online.OnlineSpec(**kw)
            errors.append(str(err.value))
        assert errors[0] == errors[1]


def test_device_reaches_the_campaign_and_every_engine(monkeypatch):
    """``device`` goes to the inner campaign and to every engine the
    controller builds: the Erlang probes and epochs of an autoscaled
    run, the packed fleet of a placed one."""
    devices = []
    real = port_engine.FleetEngine

    class Spy(real):
        def __init__(self, *args, **kw):
            devices.append(kw.get("device", "unset"))
            super().__init__(*args, **kw)

    monkeypatch.setattr(port_online, "FleetEngine", Spy)
    for name in ("autoscale-joint", "placement-load_shift-packed-drift"):
        spec = dataclasses.replace(SPECS[name](PORT), n_epochs=6)
        devices.clear()
        ctl = port_online.OnlineController(spec, device="cpu")
        assert ctl._campaign.device == "cpu"
        report = ctl.run()
        assert devices and set(devices) == {"cpu"}
        assert report.to_payload() == ref_online.run_online(
            dataclasses.replace(SPECS[name](REF), n_epochs=6)).to_payload()


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    """``device=None`` is the card: without one the first contention-free
    sweep raises (a deploy replay on an infinite cluster), while a run
    whose replays all take the host's planes needs no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sweep_bound = dataclasses.replace(SPECS["serving-input_mix"](PORT),
                                      n_epochs=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_online.run_online(sweep_bound)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_online.OnlineController(sweep_bound).run()
    host = dataclasses.replace(SPECS["autoscale-joint"](PORT), n_epochs=6)
    got = port_online.run_online(host).to_payload()
    assert got == ref_online.run_online(dataclasses.replace(
        SPECS["autoscale-joint"](REF), n_epochs=6)).to_payload()


def test_core_exports_equal_reference():
    """``repro_torch.core`` exports every name of ``repro.core``'s
    ``__all__`` (and ``run_grid_search`` beside them)."""
    import repro_torch.core as port_core
    assert set(port_core.__all__) - {"run_grid_search"} \
        == set(repro.core.__all__)
    assert all(hasattr(port_core, name) for name in port_core.__all__)
