"""The port's serving side of distribution: the sharded prefill and serve
steps of every family against the single-device prefill and decode, on
(2, 2) and (1, 4) gloo meshes (each rank a subprocess, see
tests/_torch_ranks.py), with the kernel routes on (their plain versions
on the CPU, so this pins the per-shard routing); the kernel entry points
refusing DTensors; and the four attention helpers against the
reference's."""
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_ranks import run_ranks

import jax
import jax.numpy as jnp

from repro.models import attention as ref_attn
from repro_torch.configs import reduced_config
from repro_torch.configs.shapes import Shape
from repro_torch.launch.steps import build_step
from repro_torch.models import attention as attn
from repro_torch.models.model import Model, build_model
from repro_torch.models.transformer import tree_leaves
from _torch_serve_cases import (CASES, MAX_LEN, TOL, case_config,
                                case_inputs, heads_dim, record_kernel_calls)

#: the rank code: every case's sharded prefill step, then DECODE greedy
#: serve steps; rank 0 saves the whole logits, tokens and caches
_SERVE = """
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.distributed.sharding import distribute_tree
    from _torch_serve_cases import (BATCH, CASES, DECODE, MAX_LEN,
                                    case_config, case_inputs)
    from _torch_serve_cases import record_kernel_calls
    calls = record_kernel_calls()
    mesh = make_test_mesh(MESH, device_type="cpu")
    # a copy: the serve step updates the cache in place, and a replicated
    # DTensor's full tensor is its local tensor
    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor)
                       else t).clone()
    for name in CASES:
        cfg = case_config(name)
        params, batch = case_inputs(cfg)
        prefill = build_step(cfg, Shape("p", MAX_LEN, BATCH, "prefill"), mesh)
        serve = build_step(cfg, Shape("d", MAX_LEN, BATCH, "decode"), mesh)
        with torch.no_grad():
            calls.clear()
            logits, cache = prefill.step(*prefill.place(params, batch))
            res = dict(kernel_calls=list(calls), prefill_logits=whole(logits),
                       prefill_cache=[whole(t) for t in tree_leaves(cache)])
            p, c = serve.place(params, cache)[:2]
            tokens, steps = whole(logits)[:, -1].argmax(-1)[:, None], []
            for _ in range(DECODE):
                t = distribute_tree(tokens, serve.in_shardings[2])
                logits, new = serve.step(p, c, t)
                assert [a.placements for a in tree_leaves(new)] == \\
                    [a.placements for a in tree_leaves(c)], \\
                    "the serve step's new cache is placed as the old one"
                c = new
                steps.append(whole(logits))
                tokens = steps[-1][:, -1].argmax(-1)[:, None]
            res.update(decode_logits=steps,
                       cache=[whole(t) for t in tree_leaves(c)])
        if RANK == 0:
            torch.save(res, f"{OUT}/{name}.pt")
"""


def _serve_on(mesh, tmp):
    here = str(Path(__file__).resolve().parent)
    code = f"import sys\nsys.path.insert(0, {here!r})\nMESH = {mesh!r}\n" \
        + textwrap.dedent(_SERVE)
    return run_ranks(code, 4, tmp, timeout=280)


@pytest.fixture(scope="module")
def serve_2x2(tmp_path_factory):
    return _serve_on((2, 2), tmp_path_factory.mktemp("serve_2x2"))


@pytest.fixture(scope="module")
def serve_1x4(tmp_path_factory):
    return _serve_on((1, 4), tmp_path_factory.mktemp("serve_1x4"))


def _close(got, want, what):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               err_msg=what, **TOL)


def _assert_matches_single_device(name, got, mesh, monkeypatch):
    cfg = case_config(name)
    params, batch = case_inputs(cfg)
    model = Model(cfg, device="cpu")
    calls = record_kernel_calls(monkeypatch)
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, max_len=MAX_LEN)
        # the prefill's kernel calls, each on one rank's local shards: the
        # batch split over data, the heads over model where they divide
        assert [c[0] for c in got["kernel_calls"]] == [c[0] for c in calls]
        data, model_axis = mesh
        for (kernel, shape, _), (_, want, heads) in zip(
                got["kernel_calls"], calls):
            split = model_axis if all(n % model_axis == 0
                                      for n in heads) else 1
            assert shape[0] == want[0] // data, (kernel, shape)
            assert shape[heads_dim(kernel)] == \
                want[heads_dim(kernel)] // split, (kernel, shape)
        _close(got["prefill_logits"], logits, "prefill logits")
        want = tree_leaves(cache)
        assert len(got["prefill_cache"]) == len(want)
        for a, b in zip(got["prefill_cache"], want):
            _close(a, b, "prefill cache")
        tokens = logits[:, -1].argmax(-1)[:, None]
        for i, step in enumerate(got["decode_logits"]):
            logits, cache = model.decode_step(params, cache, tokens)
            _close(step, logits, f"decode step {i} logits")
            want_tokens = logits[:, -1].argmax(-1)[:, None]
            assert torch.equal(step[:, -1].argmax(-1)[:, None], want_tokens)
            tokens = want_tokens
        for a, b in zip(got["cache"], tree_leaves(cache)):
            _close(a, b, "cache after decode")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_single_device_2x2(serve_2x2, name,
                                                   monkeypatch):
    """(data=2, model=2): the batch over data, heads and the cache's
    sequence over model; qwen3's query and kv heads both shard, each rank
    keeping its GQA groups whole."""
    _assert_matches_single_device(name, torch.load(serve_2x2 / f"{name}.pt"),
                                  (2, 2), monkeypatch)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_single_device_1x4(serve_1x4, name,
                                                   monkeypatch):
    """(data=1, model=4): every rank holds the whole batch; qwen3's 2 kv
    heads do not divide the model axis and are replicated while its query
    heads shard."""
    _assert_matches_single_device(name, torch.load(serve_1x4 / f"{name}.pt"),
                                  (1, 4), monkeypatch)


class FakeMesh:
    """Duck-typed mesh: axis sizes and a device type, no process group."""

    def __init__(self, **shape):
        self.shape = shape
        self.device_type = "cpu"


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_step_builds_every_kind(kind):
    """build_step dispatches on the shape's kind; the inputs are meta
    trees, the cache's sequence over the model axis."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = reduced_config("qwen3-0.6b", n_layers=2)
    bundle = build_step(cfg, Shape("s", 64, 4, kind),
                        FakeMesh(data=2, model=4))
    assert bundle.kind == kind
    assert all(t.device.type == "meta"
               for spec in bundle.in_specs for t in tree_leaves(spec))
    if kind == "decode":
        params, cache, tokens = bundle.in_specs
        assert tuple(cache["layers"]["k"].shape) == (2, 4, 64, 4, 32)
        assert bundle.in_shardings[1]["layers"]["k"].placements == \
            (Shard(1), Shard(2))
        assert bundle.in_shardings[2].placements == (Shard(0), Replicate())


def test_abstract_cache_is_make_cache_on_meta():
    for arch in ("qwen3-0.6b", "zamba2-1.2b", "xlstm-350m", "whisper-tiny",
                 "llama-3.2-vision-90b"):
        model = build_model(reduced_config(arch, n_layers=2), device="cpu")
        specs, axes = model.abstract_cache(2, 32)
        cache, want_axes = model.make_cache(2, 32)
        assert axes == want_axes
        for s, c in zip(tree_leaves(specs), tree_leaves(cache)):
            assert s.device.type == "meta"
            assert (s.shape, s.dtype) == (c.shape, c.dtype)


# --------------------------------------------------------------------------
# the kernel entry points refuse a DTensor
# --------------------------------------------------------------------------

_REFUSE = """
    import pytest
    from torch.distributed.tensor import distribute_tensor, Replicate
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    mesh = make_test_mesh((2,), ("model",), device_type="cpu")
    d = lambda *shape: distribute_tensor(torch.randn(*shape), mesh,
                                         [Replicate()])
    p = torch.randn
    calls = {
        "flash_attention": lambda: flash_ops.flash_attention(
            d(1, 8, 2, 32), p(1, 8, 2, 32), p(1, 8, 2, 32)),
        "fused_rmsnorm": lambda: rms_ops.fused_rmsnorm(
            p(4, 16), d(4, 16), p(16)),
        "ssd_intra": lambda: ssd_ops.ssd_intra(
            p(1, 1, 8, 2, 4), p(1, 1, 8, 3), d(1, 1, 8, 3), p(1, 1, 8, 2),
            p(1, 1, 8, 2)),
        "ssd_inter": lambda: ssd_ops.ssd_inter(
            p(1, 1, 8, 3), p(1, 1, 8, 2), p(1, 1, 2, 3, 4), p(1, 1, 2),
            p(1, 1, 8, 2, 4), torch.float32, d(1, 2, 3, 4)),
        "ssd_scan": lambda: ssd_ops.ssd_scan(
            d(1, 8, 2, 4), p(1, 8, 3), p(1, 8, 3), p(1, 8, 2), p(1, 8, 2)),
    }
    launches = (flash_ops.launches, rms_ops.launches,
                ssd_ops.intra_launches, ssd_ops.inter_launches)
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"{name}: takes plain tensors"):
            call()
    assert launches == (flash_ops.launches, rms_ops.launches,
                        ssd_ops.intra_launches, ssd_ops.inter_launches)
"""


def test_kernel_entry_points_refuse_dtensors(tmp_path):
    """Each of the five entry points raises ValueError naming itself when
    any argument is a DTensor, and launches nothing."""
    run_ranks(_REFUSE, 2, tmp_path, timeout=120)


def test_kernel_entry_points_take_meta_tensors_plainly():
    """A meta tensor (the dry run's) takes the plain version, as a CPU
    tensor does: shapes come out, nothing launches."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    m = lambda *shape: torch.empty(*shape, device="meta")
    before = (flash_ops.launches, ssd_ops.intra_launches,
              ssd_ops.inter_launches)
    out = flash_ops.flash_attention(m(1, 8, 4, 32), m(1, 8, 2, 32),
                                    m(1, 8, 2, 32))
    assert out.device.type == "meta" and tuple(out.shape) == (1, 8, 4, 32)
    y, h = ssd_ops.ssd_scan(m(1, 64, 2, 4), m(1, 64, 3), m(1, 64, 3),
                            m(1, 64, 2), m(1, 64, 2), chunk=32)
    assert (tuple(y.shape), tuple(h.shape)) == ((1, 64, 2, 4), (1, 2, 3, 4))
    assert before == (flash_ops.launches, ssd_ops.intra_launches,
                      ssd_ops.inter_launches)


# --------------------------------------------------------------------------
# the attention helpers against the reference's
# --------------------------------------------------------------------------

#: heads, kv heads, head dim, model width; the reference's bf16 attention
#: tolerance (tests/test_kernels.py)
H, HKV, HD, D = 4, 2, 16, 32
BF16_TOL = dict(atol=6e-2, rtol=6e-2)
FP32_TOL = dict(atol=1e-5, rtol=1e-5)


def _helper_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    w = lambda *shape: (rng.standard_normal(shape) * 0.2).astype(np.float32)
    params = {"wq": w(D, H * HD), "wk": w(D, HKV * HD), "wv": w(D, HKV * HD),
              "wo": w(H * HD, D), "q_norm": 1 + w(HD), "k_norm": 1 + w(HD)}
    x = w(2, 12, D) * 5
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in params.items()}
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in params.items()}
    return jp, tp, x, tdt


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


_GEOM = dict(n_heads=H, kv_heads=HKV, head_dim=HD)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_matches_reference(dtype, cross):
    jp, tp, x, tdt = _helper_inputs(dtype)
    kv = x[:, :7] * 0.5 if cross else None
    want = jax.jit(lambda p, x, kv: ref_attn.attention(
        p, x, rope_theta=1e4, kv_x=kv, **_GEOM))(
        jp, jnp.asarray(x).astype(dtype),
        None if kv is None else jnp.asarray(kv).astype(dtype))
    got = attn.attention(tp, torch.from_numpy(x).to(tdt), rope_theta=1e4,
                         kv_x=None if kv is None else
                         torch.from_numpy(kv).to(tdt), impl="kernel",
                         **_GEOM)
    tol = FP32_TOL if dtype == jnp.float32 else BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_init_kv_cache_matches_reference():
    want = ref_attn.init_kv_cache(3, HKV, 20, HD, jnp.bfloat16)
    got = attn.init_kv_cache(3, HKV, 20, HD, torch.bfloat16, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].float().any()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_prefill_into_cache_then_decode_attention_match_reference(dtype):
    """A 12-token prefill into a 20-deep cache, then three one-token
    decodes, each output and cache against the reference's."""
    jp, tp, x, tdt = _helper_inputs(dtype)
    tol = FP32_TOL if dtype == jnp.float32 else BF16_TOL
    kw = dict(rope_theta=1e4, **_GEOM)
    want_out, want_cache = jax.jit(lambda p, x: ref_attn.prefill_into_cache(
        p, x, max_len=20, **kw))(jp, jnp.asarray(x).astype(dtype))
    got_out, got_cache = attn.prefill_into_cache(
        tp, torch.from_numpy(x).to(tdt), max_len=20, impl="kernel", **kw)
    np.testing.assert_allclose(_f32(got_out), _f32(want_out), **tol)
    rng = np.random.default_rng(1)
    decode = jax.jit(lambda p, x, c: ref_attn.decode_attention(p, x, c,
                                                               **kw))
    for step in range(3):
        for k in want_cache:
            np.testing.assert_allclose(_f32(got_cache[k]),
                                       _f32(want_cache[k]), err_msg=k, **tol)
        x1 = rng.standard_normal((2, 1, D)).astype(np.float32)
        want_out, want_cache = decode(jp, jnp.asarray(x1).astype(dtype),
                                      want_cache)
        got_out, got_cache = attn.decode_attention(
            tp, torch.from_numpy(x1).to(tdt), got_cache, **kw)
        np.testing.assert_allclose(_f32(got_out), _f32(want_out),
                                   err_msg=f"decode {step}", **tol)
    assert got_cache["length"].tolist() == [15, 15]
