"""The port's stage-graph autotuner against the reference's.

Given the reference's TPU constants (mapped field by field onto the port's
``HardwareSpec``), the port's H100 stage oracle and planner must reproduce
the reference's runtimes, OOMs and plans exactly; with their H100 defaults
they must keep the properties the reference's own tests pin
(``tests/test_sharding_and_autotune.py``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.autotune import oracle as ref_oracle
from repro.autotune import plan as ref_plan
from repro.autotune.stages import build_stage_graph as ref_build
from repro.configs import ARCH_IDS, SHAPES as REF_SHAPES
from repro.configs import cells_for as ref_cells_for
from repro.configs import get_config as ref_get_config
from repro.core.dag import Node as RefNode
from repro.core.env import ExecutionError as RefExecutionError
from repro.core.resources import ResourceConfig as RefConfig
from repro.roofline.hw import TPU_V5E
from repro_torch.autotune import oracle as port_oracle
from repro_torch.autotune import plan as port_plan
from repro_torch.autotune.stages import build_stage_graph as port_build
from repro_torch.configs import SHAPES as PORT_SHAPES
from repro_torch.configs import cells_for as port_cells_for
from repro_torch.configs import get_config as port_get_config
from repro_torch.core.dag import Node as PortNode
from repro_torch.core.env import ExecutionError as PortExecutionError
from repro_torch.core.resources import ResourceConfig as PortConfig
from repro_torch.models.model import REMAT
from repro_torch.roofline.hw import H100_SXM, HardwareSpec

#: the reference's target, on the port's field names
TPU_AS_PORT = HardwareSpec(
    name=TPU_V5E.name, peak_flops_bf16=TPU_V5E.peak_flops_bf16,
    hbm_bandwidth=TPU_V5E.hbm_bandwidth,
    nvlink_link_bandwidth=TPU_V5E.ici_link_bandwidth,
    nvlink_links_per_chip=TPU_V5E.ici_links_per_chip,
    hbm_bytes=TPU_V5E.hbm_bytes, smem_bytes_per_sm=TPU_V5E.vmem_bytes)
TPU_ORACLE = port_oracle.OracleConfig(hw=TPU_AS_PORT)
PLAN_ARCHS = ["olmo-1b", "qwen2-moe-a2.7b"]


def graph(wf):
    return ([(n.name, dataclasses.astuple(n.payload)) for n in wf],
            [(n, wf.successors(n)) for n in wf.nodes],
            wf.topological_order())


def test_shapes_and_cells_equal_reference():
    assert {k: dataclasses.astuple(v) for k, v in PORT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}
    for arch in ARCH_IDS:
        assert port_cells_for(port_get_config(arch)) == \
            ref_cells_for(ref_get_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stage_graph_equals_reference(arch):
    """Nodes, edges, order and every StageSpec, for every shape (the
    optimizer stage counts the port's parameters on the meta device)."""
    ref_cfg, port_cfg = ref_get_config(arch), port_get_config(arch)
    for shape in REF_SHAPES:
        assert graph(port_build(port_cfg, PORT_SHAPES[shape])) == \
            graph(ref_build(ref_cfg, REF_SHAPES[shape]))


def runtime_or_oom(oracle, node):
    try:
        return oracle.runtime(node)
    except (RefExecutionError, PortExecutionError) as exc:
        return ("oom", str(exc))


def test_stage_oracle_with_tpu_constants_equals_reference():
    """Runtimes, thrash times, chip counts and OOMs over every stage of
    two models' graphs and a grid of (cpu, mem) configurations."""
    ref, port = ref_oracle.TPUStageOracle(), \
        port_oracle.GPUStageOracle(TPU_ORACLE)
    n_oom = n = 0
    for arch in ("qwen1.5-32b", "qwen2-moe-a2.7b"):
        for shape in ("train_4k", "decode_32k"):
            wf = ref_build(ref_get_config(arch), REF_SHAPES[shape])
            for stage in wf:
                for cpu in (0.1, 0.5, 2.0, 10.0):
                    for mem in (128.0, 1024.0, 6144.0, 10240.0):
                        a = RefNode(stage.name, config=RefConfig(cpu, mem),
                                    payload=stage.payload)
                        b = PortNode(stage.name,
                                     config=PortConfig(cpu, mem),
                                     payload=stage.payload)
                        want = runtime_or_oom(ref, a)
                        assert runtime_or_oom(port, b) == want
                        assert port.clamped(b) == ref.clamped(a)
                        assert port.chips(b) == ref.chips(a)
                        n_oom += isinstance(want, tuple)
                        n += 1
    assert 0 < n_oom < n


def plans_equal(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("method", ["aarc", "maff", "bo"])
@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_plan_with_tpu_constants_equals_reference(arch, method):
    """At the reference test's SLO: twice the all-resources step time."""
    ref_cfg, port_cfg = ref_get_config(arch), port_get_config(arch)
    shape = "train_4k"
    base = ref_plan(ref_cfg, REF_SHAPES[shape], 1e9, method="aarc",
                    max_trail=0)
    plans_equal(port_plan(port_cfg, PORT_SHAPES[shape], 1e9, method="aarc",
                          max_trail=0, oracle_cfg=TPU_ORACLE), base)
    slo = 2.0 * base.step_time
    plans_equal(port_plan(port_cfg, PORT_SHAPES[shape], slo, method=method,
                          oracle_cfg=TPU_ORACLE),
                ref_plan(ref_cfg, REF_SHAPES[shape], slo, method=method))


def test_bo_plan_with_tpu_constants_equals_reference_at_fixed_slo():
    """The reference's search-cost test's cell: olmo-1b at 0.6 s, BO with
    40 rounds."""
    plans_equal(port_plan(port_get_config("olmo-1b"),
                          PORT_SHAPES["train_4k"], 0.6, method="bo",
                          max_trail=40, oracle_cfg=TPU_ORACLE),
                ref_plan(ref_get_config("olmo-1b"), REF_SHAPES["train_4k"],
                         0.6, method="bo", max_trail=40))


def test_h100_spec_and_oracle_defaults():
    assert port_oracle.OracleConfig().hw == H100_SXM
    assert (H100_SXM.peak_flops_bf16, H100_SXM.hbm_bandwidth,
            H100_SXM.hbm_bytes) == (989e12, 3.35e12, 80e9)
    # 900 GB/s bidirectional over 18 links
    assert H100_SXM.nvlink_link_bandwidth * 2 * \
        H100_SXM.nvlink_links_per_chip == 900e9
    assert port_oracle.OracleConfig().pod_chips == 256
    pricing = port_oracle.GPU_PRICING
    assert (pricing.mu0, pricing.mu1, pricing.mu2) == (0.512, 0.001, 0.0)


@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_h100_planner_keeps_reference_properties(arch):
    """The SLO is met, AARC costs less than MAFF, and every stage gets a
    chip count and a remat level (the reference's planner test)."""
    cfg, shape = port_get_config(arch), PORT_SHAPES["train_4k"]
    base = port_plan(cfg, shape, 1e9, method="aarc", max_trail=0).step_time
    slo = 2.0 * base
    r_aarc = port_plan(cfg, shape, slo, method="aarc")
    r_maff = port_plan(cfg, shape, slo, method="maff")
    assert r_aarc.step_time <= slo + 1e-9
    assert r_maff.step_time <= slo + 1e-9
    assert r_aarc.cost < r_maff.cost, (r_aarc.cost, r_maff.cost)
    for name, sp in r_aarc.stages.items():
        assert sp.chips >= 1
        assert sp.remat in REMAT


def test_h100_planner_search_cheaper_than_bo():
    """AARC profiles for less modeled wall time than BO (the reference's
    test, at its SLO of 0.6 s)."""
    cfg, shape = port_get_config("olmo-1b"), PORT_SHAPES["train_4k"]
    r_aarc = port_plan(cfg, shape, 0.6, method="aarc")
    r_bo = port_plan(cfg, shape, 0.6, method="bo", max_trail=40)
    assert r_aarc.step_time <= 0.6
    assert r_aarc.search_runtime < r_bo.search_runtime
