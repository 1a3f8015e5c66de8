"""The port's training (optimizer, train step, remat, data, launcher)
against the JAX package's, on bridged weights and the reference's
batches; and the kernel entry points' refusal of autograd."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as ref_registry
from repro.models.model import Model as RefModel
from repro.training import data as ref_data
from repro.training import optimizer as ref_opt
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch import bridge
from repro_torch.autotune import plan
from repro_torch.configs import SHAPES, get_config, reduced_config
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import model as model_mod
from repro_torch.models.attention import sdpa
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, global_norm,
                                            schedule)
from repro_torch.training.train_step import make_train_step

#: loss and gradient tolerance of the reference (tests/test_training.py)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
#: the optimizer on identical gradients
OPT_TOL = dict(atol=1e-6, rtol=1e-6)
ARCHS = ("qwen3-0.6b", "olmo-1b", "zamba2-1.2b")


def _batch_np(vocab, seq=16, batch=8, step=0):
    """The reference dataset's batch as int64 numpy arrays."""
    ds = ref_data.SyntheticDataset(vocab=vocab, seq_len=seq,
                                   global_batch=batch)
    return {k: np.asarray(v, np.int64) for k, v in ds.batch_at(step).items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v, jnp.int32) for k, v in b.items()}


def _leaves(tree):
    """numpy leaves in the sorted-key order of ``jax.tree.leaves``."""
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def _assert_trees_close(got, want, **tol):
    got, want = _leaves(bridge.to_numpy(got)), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


def _port_grads(model, params, batch):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss, _ = model.loss(tree_map(lambda _: next(it), params),
                         batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


@pytest.fixture(scope="module")
def reference():
    """Per arch (reduced, 2 layers): the reference model, its params, a
    batch and its jitted loss and gradients, paid once per module."""
    out = {}
    for arch in ARCHS:
        cfg = ref_registry.reduced_config(arch, n_layers=2)
        model = RefModel(cfg)
        params = model.init(jax.random.key(0))
        batch = _batch_np(cfg.vocab)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b)[0]))(params, _jax_batch(batch))
        out[arch] = dict(model=model, params=params, batch=batch,
                         loss=float(loss), grads=grads)
    return out


def _port(arch, reference, **overrides):
    model = Model(reduced_config(arch, n_layers=2, **overrides),
                  device="cpu")
    params = bridge.from_reference(
        jax.tree.map(np.asarray, reference[arch]["params"]), device="cpu")
    return model, params


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_and_grads_match_reference(reference, arch, remat):
    """Model.loss and its gradients against jax.value_and_grad; zamba2
    through the plain chunked SSD (use_ssm_kernel=False)."""
    model, params = _port(arch, reference, remat=remat)
    ref = reference[arch]
    loss, grads = _port_grads(model, params, _torch_batch(ref["batch"]))
    np.testing.assert_allclose(float(loss), ref["loss"], **GRAD_TOL)
    _assert_trees_close(grads, ref["grads"], **GRAD_TOL)


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------

def test_schedule_matches_reference():
    """Warmup, cosine and the clamp past total_steps."""
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    steps = np.arange(0, 131, dtype=np.int32)
    want = [float(ref_opt.schedule(ref_opt.AdamWConfig(**cfg),
                                   jnp.asarray(s))) for s in steps]
    got = [float(schedule(AdamWConfig(**cfg), torch.tensor(int(s))))
           for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[0] == 0.0
    assert got[10] == pytest.approx(1e-3, rel=1e-2)
    assert got[100] == pytest.approx(1e-4, rel=1e-2)
    assert got[130] == got[100]


def test_adamw_update_matches_reference_on_identical_grads(reference):
    """Two AdamW steps fed the reference's gradients (bridged) give the
    reference's params, m and v, and its lr and grad_norm."""
    ref = reference["qwen3-0.6b"]
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    want = ref_opt.adamw_init(ref["params"])
    _, params = _port("qwen3-0.6b", reference)
    got = adamw_init(params)
    grads = bridge.from_reference(jax.tree.map(np.asarray, ref["grads"]),
                                  device="cpu")
    for _ in range(2):
        want, want_m = jax.jit(ref_opt.adamw_update, static_argnums=2)(
            want, ref["grads"], ref_opt.AdamWConfig(**cfg))
        got, got_m = adamw_update(got, grads, AdamWConfig(**cfg))
        for part in ("params", "m", "v"):
            _assert_trees_close(got[part], want[part], **OPT_TOL)
        assert int(got["step"]) == int(want["step"])
        assert got["step"].dtype == torch.int32
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                       **OPT_TOL)


def test_adamw_update_bf16_rounding_points():
    """bf16 params move by (lr * delta) rounded to bf16; m and v stay
    fp32. Against the reference on the same leaves."""
    rng = np.random.default_rng(3)
    p32 = rng.standard_normal((64, 32)).astype(np.float32)
    g = rng.standard_normal((64, 32)).astype(np.float32)
    cfg = dict(lr=1e-2, warmup_steps=0, weight_decay=0.1)
    want, _ = ref_opt.adamw_update(
        ref_opt.adamw_init({"w": jnp.asarray(p32, jnp.bfloat16)}),
        {"w": jnp.asarray(g)}, ref_opt.AdamWConfig(**cfg))
    got, _ = adamw_update(
        adamw_init({"w": torch.from_numpy(p32).to(torch.bfloat16)}),
        {"w": torch.from_numpy(g)}, AdamWConfig(**cfg))
    assert got["params"]["w"].dtype == torch.bfloat16
    assert got["m"]["w"].dtype == got["v"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(
        got["params"]["w"].float().numpy(),
        np.asarray(want["params"]["w"], np.float32))
    for part in ("m", "v"):
        np.testing.assert_allclose(got[part]["w"].numpy(),
                                   np.asarray(want[part]["w"]), **OPT_TOL)


def test_adamw_converges_on_quadratic():
    """Minimise ||x - t||^2: the update's arithmetic is right."""
    target = torch.tensor([1.0, -2.0, 3.0])
    state = adamw_init({"x": torch.zeros(3)})
    cfg = AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=0,
                      total_steps=500, min_lr_ratio=1.0)
    for _ in range(300):
        g = {"x": 2 * (state["params"]["x"] - target)}
        state, _ = adamw_update(state, g, cfg)
    np.testing.assert_allclose(state["params"]["x"].numpy(), target.numpy(),
                               atol=1e-2)


def test_grad_clipping_bounds_update():
    state = adamw_init({"x": torch.zeros(4)})
    cfg = AdamWConfig(lr=1e-2, grad_clip=1.0, weight_decay=0.0,
                      warmup_steps=0)
    new, metrics = adamw_update(state, {"x": torch.full((4,), 1e6)}, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    assert float(new["params"]["x"].abs().max()) <= 2e-2
    assert float(global_norm({"a": torch.ones(4), "b": {"c": torch.ones(
        5, dtype=torch.bfloat16)}})) == pytest.approx(3.0)
    # functional: the old state is untouched
    assert float(state["params"]["x"].abs().max()) == 0.0
    assert int(state["step"]) == 0 and int(new["step"]) == 1


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_steps(reference):
    """One jitted reference train step of reduced olmo-1b at m = 1 and 4."""
    ref = reference["olmo-1b"]
    state = ref_opt.adamw_init(ref["params"])
    out = {}
    for m in (1, 4):
        step = jax.jit(ref_make_train_step(
            ref["model"], ref_opt.AdamWConfig(lr=1e-3), microbatches=m))
        new, metrics = step(state, _jax_batch(ref["batch"]))
        out[m] = (new, {k: float(v) for k, v in metrics.items()})
    return out


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_reference(reference, reference_steps,
                                      microbatches):
    """A whole step: loss, grad_norm and lr as the reference's; params
    within 2 lr (+1e-6), since Adam's first step moves every element by
    about +-lr, and a gradient near 0 may differ in sign."""
    lr = 1e-3
    model, params = _port("olmo-1b", reference)
    step = make_train_step(model, AdamWConfig(lr=lr),
                           microbatches=microbatches)
    state = adamw_init(params)
    new, metrics = step(state, _torch_batch(reference["olmo-1b"]["batch"]))
    want, want_m = reference_steps[microbatches]
    assert sorted(metrics) == sorted(want_m)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), want_m[k], **GRAD_TOL)
    for g, w in zip(_leaves(bridge.to_numpy(new["params"])),
                    _leaves(want["params"])):
        assert np.abs(g - w).max() <= 2 * lr + 1e-6
    assert int(new["step"]) == 1 and int(state["step"]) == 0


def test_microbatch_grad_accum_matches_full_batch(reference):
    """Gradients summed in fp32 over 4 microbatches and divided by 4
    equal the full batch's (the step's own accumulation, read through
    grad_transform)."""
    model, params = _port("olmo-1b", reference)
    batch = _torch_batch(reference["olmo-1b"]["batch"])
    _, g_full = _port_grads(model, params, batch)
    seen = {}

    def capture(grads):
        seen["g"] = grads
        return grads

    step = make_train_step(model, AdamWConfig(lr=1e-3), microbatches=4,
                           grad_transform=capture)
    step(adamw_init(params), batch)
    for a, f in zip(tree_leaves(seen["g"]), tree_leaves(g_full)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), f.numpy(), **GRAD_TOL)


def test_microbatched_step_matches_single_step(reference):
    model, params = _port("olmo-1b", reference)
    batch = _torch_batch(reference["olmo-1b"]["batch"])
    state = adamw_init(params)
    s1, m1 = make_train_step(model, AdamWConfig(lr=1e-3))(state, batch)
    s4, m4 = make_train_step(model, AdamWConfig(lr=1e-3),
                             microbatches=4)(state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-3)
    assert "ce" in m1 and "ce" not in m4
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(s1["params"]), tree_leaves(s4["params"])))
    assert d < 5e-3
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, AdamWConfig(), microbatches=3)(state, batch)


def test_loss_halves_over_50_steps():
    """Memorise one small fixed batch."""
    model = Model(reduced_config("olmo-1b", n_layers=2), device="cpu")
    state = adamw_init(model.init(seed=0))
    batch = SyntheticDataset(vocab=model.cfg.vocab, seq_len=16,
                             global_batch=4, device="cpu").batch_at(0)
    step = make_train_step(
        model, AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100))
    losses = []
    for _ in range(50):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < 0.5 * losses[0], losses[::10]


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

class _OpCount(TorchDispatchMode):
    """Counts the aten ops run while it is active."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b"])
def test_remat_levels_give_equal_grads_and_recompute(reference, arch):
    """none / dots / full give bit-equal gradients. In backward, "full"
    runs the forward's projections again and "dots" does not (it saves
    them), while both run the softmax again (recomputed, not saved)."""
    aten = torch.ops.aten
    batch = _torch_batch(reference[arch]["batch"])
    grads, counts = {}, {}
    for remat in ("none", "dots", "full"):
        model, params = _port(arch, reference, remat=remat)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        loss, _ = model.loss(tree_map(lambda _: next(it), params),
                             batch)
        with _OpCount() as count:
            grads[remat] = torch.autograd.grad(loss, leaves)
        counts[remat] = count.n
    for remat in ("dots", "full"):
        assert all(torch.equal(a, b)
                   for a, b in zip(grads[remat], grads["none"])), remat
    # one softmax per attention application: each layer's (dense), each
    # application of the shared block (hybrid)
    n_attn = sum(layer.kind == "attn" for layer in model.layer_plan())
    softmax = lambda r: counts[r].get(aten._softmax.default, 0)
    mm = lambda r: counts[r].get(aten.mm.default, 0)
    assert softmax("none") == 0
    assert softmax("dots") == softmax("full") == n_attn
    assert mm("dots") == mm("none") < mm("full")


def test_remat_only_while_grad_is_on():
    f = lambda x: x
    with torch.no_grad():
        assert model_mod._maybe_remat(f, "full") is f
        assert model_mod._maybe_remat(f, "dots") is f
    assert model_mod._maybe_remat(f, "none") is f
    assert model_mod._maybe_remat(f, "full") is not f
    with pytest.raises(ValueError, match="remat"):
        model_mod._maybe_remat(f, "everything")


# --------------------------------------------------------------------------
# data and the launcher
# --------------------------------------------------------------------------

def test_dataset_deterministic_and_host_sharded():
    ds = SyntheticDataset(vocab=100, seq_len=8, global_batch=8, device="cpu")
    b1, b2, b3 = ds.batch_at(3), ds.batch_at(3), ds.batch_at(4)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].shape == (8, 8) and b1["tokens"].dtype == torch.int64
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 100
    h0 = ds.batch_at(3, host_index=0, host_count=2)
    h1 = ds.batch_at(3, host_index=1, host_count=2)
    assert h0["tokens"].shape[0] == 4
    assert not torch.equal(h0["tokens"], h1["tokens"])
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    other = dataclasses.replace(ds, seed=1).batch_at(3)
    assert not torch.equal(other["tokens"], b1["tokens"])
    with pytest.raises(ValueError, match="hosts"):
        ds.batch_at(0, host_count=3)


def test_launcher_trains_reduced_on_cpu(tmp_path, capsys):
    ck = tmp_path / "ck"
    assert launch_train.main(
        ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
         "--steps", "6", "--batch", "4", "--seq", "16", "--ckpt-every", "3",
         "--log-every", "3", "--microbatches", "2", "--remat", "dots",
         "--ckpt-dir", str(ck)]) == 0
    out = capsys.readouterr().out
    assert "remat=dots" in out and "done: 6 steps, 0 failures" in out
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000003",
                                                    "step_00000006"]
    # --autotune-slo: the port's planner picks the trunk's remat level by
    # the reference's majority rule, and the model trains with it
    r = plan(get_config("qwen3-0.6b"), SHAPES["train_4k"], 0.1,
             method="aarc")
    remats = [p.remat for n, p in r.stages.items() if n.startswith("layers")]
    picked = max(set(remats), key=remats.count)
    assert launch_train.main(
        ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps",
         "1", "--batch", "2", "--seq", "16", "--autotune-slo", "0.1",
         "--ckpt-dir", str(tmp_path / "ck_autotune")]) == 0
    out = capsys.readouterr().out
    assert f"autotune: AARC plan -> remat={picked} " in out
    assert f"remat={picked}, device=cpu" in out
    assert "done: 1 steps, 0 failures" in out


# --------------------------------------------------------------------------
# the kernel entry points refuse autograd
# --------------------------------------------------------------------------

def _ssd_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 1, 32, 2, 16, 8
    xh = torch.randn(b, s, h, p, generator=g)
    bm, cm = torch.randn(b, s, n, generator=g), torch.randn(b, s, n,
                                                          generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g))
    log_a = -dt * 0.5
    xh.requires_grad_(requires_grad)
    return xh, bm, cm, log_a, dt


def test_kernel_entry_points_refuse_autograd():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 4, 32, generator=g, requires_grad=True)
    k = torch.randn(1, 16, 2, 32, generator=g)
    x, r = torch.randn(2, 8, 64, generator=g), torch.randn(2, 8, 64,
                                                         generator=g)
    w = torch.ones(64, requires_grad=True)
    xh, bm, cm, log_a, dt = _ssd_inputs(True)
    chunks = [t.reshape(1, 2, 16, *t.shape[2:]) for t in (xh, bm, cm)]
    with pytest.raises(ValueError, match="attn_impl='plain'"):
        sdpa(q, k, k, causal=True, impl="kernel")
    with pytest.raises(ValueError, match="use_ssm_kernel=False"):
        rms_ops.fused_rmsnorm(x, r, w)
    with pytest.raises(ValueError, match="no backward"):
        ssd_ops.ssd_scan(xh, bm, cm, log_a, dt, chunk=16)
    with pytest.raises(ValueError, match="no backward"):
        ssd_ops.ssd_intra(*chunks, log_a.reshape(1, 2, 16, 2),
                          dt.reshape(1, 2, 16, 2))
    # the plain attention path still differentiates
    out = sdpa(q, k, k, causal=True, impl="plain")
    assert out.requires_grad
    # under no_grad (serving) every entry point runs
    with torch.no_grad():
        assert sdpa(q, k, k, causal=True, impl="kernel").shape == q.shape
        y, s = rms_ops.fused_rmsnorm(x, r, w)
        assert y.shape == x.shape
        y, h_last = ssd_ops.ssd_scan(xh, bm, cm, log_a, dt, chunk=16)
        assert y.shape == xh.shape and not y.requires_grad
        y_intra, s_chunk, dec, cum = ssd_ops.ssd_intra(
            *chunks, log_a.reshape(1, 2, 16, 2), dt.reshape(1, 2, 16, 2))
    s_chunk.requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        ssd_ops.ssd_inter(chunks[2], cum, s_chunk, dec, y_intra,
                          torch.float32)


@pytest.mark.parametrize("overrides", [
    dict(arch="qwen3-0.6b", attn_impl="kernel"),
    dict(arch="zamba2-1.2b", use_ssm_kernel=True)])
def test_train_step_refuses_kernel_configs(overrides):
    overrides = dict(overrides)
    model = Model(reduced_config(overrides.pop("arch"), **overrides),
                  device="cpu")
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(model, AdamWConfig())
