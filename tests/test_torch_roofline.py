"""The port's roofline: its terms, MODEL_FLOPS and depth extrapolation
against the reference's, its collective counting against the reference's
HLO parse, its per-rank FLOP counting on DTensors, the exact linearity of
its counts in units, and one dry-run cell. Fake process groups
(``torch.testing``'s ``"fake"`` backend: one process, every collective
returns at once) stand in for the meshes."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist
from _torch_ranks import SRC

from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.roofline import analysis as ref_analysis
from repro.roofline import measure as ref_measure
from repro.roofline.hw import TPU_V5E
from repro_torch.configs import SHAPES, get_config, reduced_config
from repro_torch.configs.shapes import Shape
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models.model import Model
from repro_torch.roofline import analysis, measure
from repro_torch.roofline.hw import HardwareSpec

#: the reference's TPU v5e constants in the port's HardwareSpec, so the
#: port's arithmetic can be held to the reference's exactly
TPU_AS_PORT = HardwareSpec(
    name=TPU_V5E.name, peak_flops_bf16=TPU_V5E.peak_flops_bf16,
    hbm_bandwidth=TPU_V5E.hbm_bandwidth,
    nvlink_link_bandwidth=TPU_V5E.ici_link_bandwidth,
    nvlink_links_per_chip=TPU_V5E.ici_links_per_chip,
    hbm_bytes=TPU_V5E.hbm_bytes, smem_bytes_per_sm=TPU_V5E.vmem_bytes)

#: the reference's run_cell result keys (src/repro/launch/dryrun.py)
REF_RESULT_KEYS = {
    "arch", "shape", "mesh", "chips", "ok", "kind", "flops_per_chip",
    "bytes_per_chip", "collective_bytes_weighted", "collective_by_kind",
    "collective_counts", "compute_s", "memory_s", "collective_s",
    "dominant", "model_flops", "useful_ratio", "flops_source", "lower_s",
    "compile_s", "microbatches", "remat", "memory_analysis"}
REF_MEMORY_KEYS = {"temp_size_in_bytes", "argument_size_in_bytes",
                   "output_size_in_bytes", "alias_size_in_bytes",
                   "generated_code_size_in_bytes"}


@pytest.fixture
def fake_world():
    """A fake process group of 4 ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(size):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the arithmetic against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("terms", [(3.2e14, 1.7e12, 4.4e10), (0.0, 5.0, 7.0),
                                   (1e9, 0.0, 0.0)])
def test_roofline_terms_match_reference(terms):
    assert analysis.roofline_terms(*terms, hw=TPU_AS_PORT) == \
        ref_analysis.roofline_terms(*terms, hw=TPU_V5E)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    for name, shape in SHAPES.items():
        assert analysis.model_flops_for(get_config(arch), shape) == \
            ref_analysis.model_flops_for(ref_get_config(arch),
                                         REF_SHAPES[name]), name


@pytest.mark.parametrize("u_target", [1, 2, 3, 28, 100])
def test_extrapolate_matches_reference(u_target):
    m1 = {"flops": 1.5e12, "bytes": 3.25e10, "coll_weighted": 7.0e8,
          "coll_by_kind": {"all-gather": 5.0e8, "all-reduce": 1.0e8},
          "coll_counts": {"all-gather": 12, "all-reduce": 3}}
    m2 = {"flops": 2.75e12, "bytes": 5.5e10, "coll_weighted": 1.3e9,
          "coll_by_kind": {"all-gather": 9.0e8, "reduce-scatter": 2.0e8},
          "coll_counts": {"all-gather": 23, "reduce-scatter": 4}}
    assert measure.extrapolate(m1, m2, u_target) == \
        ref_measure.extrapolate(m1, m2, u_target)


# --------------------------------------------------------------------------
# collective counting against the reference's HLO parse
# --------------------------------------------------------------------------

def test_collective_bytes_match_reference_hlo(fake_world):
    """An all-gather of bf16[256,4096], an all-reduce of f32[64,128] and a
    reduce-scatter to f32[16,64], issued by DTensor redistributions on a
    16-rank mesh and counted by their result buffers, against the
    reference's collective_bytes on HLO lines of those results."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    fake_world(16)
    mesh = make_test_mesh((16,), ("model",), device_type="cpu")

    def step(a, b, c):
        a.redistribute(mesh, [Replicate()])
        b.redistribute(mesh, [Replicate()])
        c.redistribute(mesh, [Shard(0)])

    m = lambda *shape, dtype=torch.float32: torch.empty(
        *shape, dtype=dtype, device="meta")
    a = DTensor.from_local(m(16, 4096, dtype=torch.bfloat16), mesh,
                           [Shard(0)])
    b = DTensor.from_local(m(64, 128), mesh, [Partial()])
    c = DTensor.from_local(m(256, 64), mesh, [Partial()])
    _, counts = analysis.count_step(step, a, b, c)
    hlo = textwrap.dedent("""\
        %all-gather.1 = bf16[256,4096]{1,0} all-gather(bf16[16,4096]{1,0} %p0), dimensions={0}
        %all-reduce.2 = f32[64,128]{1,0} all-reduce(f32[64,128]{1,0} %p1), to_apply=%add
        %reduce-scatter.3 = f32[16,64]{1,0} reduce-scatter(f32[256,64]{1,0} %p2), dimensions={0}
        """)
    assert counts.collective_bytes() == ref_analysis.collective_bytes(hlo)


# --------------------------------------------------------------------------
# FLOPs per rank
# --------------------------------------------------------------------------

def _matmul_flops(place_x, place_w, mesh):
    from torch.distributed.tensor import distribute_tensor
    x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh, place_x)
    w = distribute_tensor(torch.empty(32, 48, device="meta"), mesh, place_w)
    return analysis.count_step(lambda x, w: x @ w, x, w)[1].flops


def test_flops_of_an_op_sharded_over_both_axes_count_one_quarter(fake_world):
    from torch.distributed.tensor import Replicate, Shard
    fake_world(4)
    mesh = make_test_mesh((2, 2), device_type="cpu")
    whole = 2 * 64 * 32 * 48
    assert _matmul_flops((Shard(0), Replicate()), (Replicate(), Shard(1)),
                         mesh) == whole / 4
    # a contraction split over one axis (a partial sum) and rows over the
    # other
    assert _matmul_flops((Shard(0), Shard(1)), (Replicate(), Shard(0)),
                         mesh) == whole / 4


def test_flops_of_a_replicated_op_count_whole(fake_world):
    from torch.distributed.tensor import Replicate
    fake_world(4)
    mesh = make_test_mesh((2, 2), device_type="cpu")
    assert _matmul_flops((Replicate(), Replicate()),
                         (Replicate(), Replicate()), mesh) == 2 * 64 * 32 * 48


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_flops_on_a_one_rank_mesh_equal_the_plain_count(fake_world, kind):
    """The sharded step of a reduced qwen3 (kernel route, so its flash
    calls run inside per_shard on local tensors) on a (1, 1) mesh counts
    the FLOPs of the plain model call on the same meta inputs. (Not its
    bytes: the sharded decode writes its cache through other ops.)"""
    fake_world(1)
    mesh = make_test_mesh((1, 1), device_type="cpu")
    cfg = reduced_config("qwen3-0.6b", n_layers=2, attn_impl="kernel")
    shape = Shape("s", 256, 4, kind)
    bundle = build_step(cfg, shape, mesh)
    _, sharded = analysis.count_step(bundle.step,
                                     *bundle.place(*bundle.in_specs))
    model = Model(cfg, device="meta")
    if kind == "prefill":
        params, batch = bundle.in_specs
        plain = lambda: model.prefill(params, batch, max_len=256)
    else:
        params, cache, tokens = bundle.in_specs
        plain = lambda: model.decode_step(params, cache, tokens)
    _, want = analysis.count_step(plain)
    assert sharded.flops == want.flops > 0


def test_analyze_step_reports_the_counted_terms(fake_world):
    """analyze_step's report carries count_step's per-rank counts and the
    terms roofline_terms makes of them, on a (2, 2) mesh."""
    fake_world(4)
    mesh = make_test_mesh((2, 2), device_type="cpu")
    cfg = reduced_config("qwen3-0.6b", n_layers=2, attn_impl="kernel")
    shape = Shape("s", 64, 4, "decode")
    bundle = build_step(cfg, shape, mesh)
    args = bundle.place(*bundle.in_specs)
    _, counts = analysis.count_step(bundle.step, *args)
    report = analysis.analyze_step(
        bundle.step, args, arch=cfg.name, shape="s", mesh_desc="2x2",
        chips=4, model_flops=analysis.model_flops_for(cfg, shape))
    weighted, by_kind, n_by_kind = counts.collective_bytes()
    assert (report.flops_per_chip, report.bytes_per_chip) == \
        (counts.flops, counts.bytes)
    assert (report.collective_bytes_weighted, report.collective_by_kind,
            report.collective_counts) == (weighted, by_kind, n_by_kind)
    assert (report.compute_s, report.memory_s, report.collective_s) == \
        analysis.roofline_terms(counts.flops, counts.bytes, weighted)
    assert report.bound_time == max(report.compute_s, report.memory_s,
                                    report.collective_s)
    assert report.peak_memory_per_chip == (
        counts.temp_bytes + counts.argument_bytes + counts.output_bytes
        - counts.alias_bytes) > 0


# --------------------------------------------------------------------------
# depth extrapolation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [("qwen3-0.6b", "prefill"),
                                       ("qwen3-0.6b", "decode"),
                                       ("zamba2-1.2b", "prefill"),
                                       ("zamba2-1.2b", "decode")])
def test_count_at_three_units_equals_the_extrapolation(fake_world, arch,
                                                       kind):
    """On a (2, 2) mesh the counts at 1, 2 and 3 units of a reduced
    config are linear in units: the 3-unit count equals the value
    extrapolated from 1 and 2, FLOPs, bytes and collectives exactly."""
    fake_world(4)
    mesh = make_test_mesh((2, 2), device_type="cpu")
    cfg = reduced_config(arch, attn_impl="kernel", use_ssm_kernel=True)
    shape = Shape("s", 64, 4, kind)
    m1, m2, m3 = (measure.measure_units(cfg, shape, mesh, build_step, u)
                  for u in (1, 2, 3))
    assert m1["flops"] < m2["flops"] and m1["coll_weighted"] > 0
    assert measure.extrapolate(m1, m2, 3) == m3


# --------------------------------------------------------------------------
# the dry run
# --------------------------------------------------------------------------

def test_dry_run_cell_on_the_production_mesh(tmp_path):
    """One run_cell of a reduced qwen3 (2 layers, the kernel route) at
    decode_32k on the fake (16, 16) mesh, in a subprocess: every
    reference result key, FLOPs per rank, the artifact written, and the
    module's import left no process group behind."""
    code = f"""
        import json, torch.distributed as dist
        from repro_torch.configs import reduced_config
        from repro_torch.launch import dryrun
        assert not dist.is_initialized()
        dryrun.get_config = lambda arch, **kw: reduced_config(
            arch, n_layers=2, **kw)
        r = dryrun.run_cell("qwen3-0.6b", "decode_32k", False,
                            {str(tmp_path)!r}, attn_impl="kernel")
        assert not dist.is_initialized()
        print(json.dumps(r))
    """
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert REF_RESULT_KEYS <= set(r)
    assert set(r["memory_analysis"]) == REF_MEMORY_KEYS
    assert r["memory_analysis"]["generated_code_size_in_bytes"] is None
    assert r["chips"] == 256 and r["mesh"] == "data=16 x model=16"
    assert "kernel routes counted as their plain versions" in \
        r["flops_source"]
    # the cache's sequence is sharded over model and gathered for decode
    assert r["collective_by_kind"]["all-gather"] > 0
    with open(tmp_path / "qwen3-0.6b__decode_32k__single.json") as f:
        assert json.load(f) == r
