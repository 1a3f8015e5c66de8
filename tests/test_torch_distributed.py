"""The port's distribution layer on several ranks of a gloo process group
(each rank a subprocess, see tests/_torch_ranks.py): the int8 gradient
sync bit for bit against the JAX package's, the sharded train step
against the single-device one, elastic resharding, sharded checkpoints
and the production meshes."""
import filecmp
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_ranks import SRC, run_ranks

from repro_torch.configs import reduced_config
from repro_torch.configs.shapes import Shape
from repro_torch.distributed.collectives import (dequantize_int8,
                                                 make_compressed_sync,
                                                 quantize_int8)
from repro_torch.launch.steps import build_step, build_train_step
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_leaves
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import make_train_step

#: the reference's sharded-step tolerances (tests/test_distributed.py)
LOSS_RTOL = 1e-4
#: the gradient tolerance of tests/test_training.py, on the global norm
GRAD_NORM_RTOL = 1e-4
PARAM_TOL = dict(atol=1e-4, rtol=1e-3)
OPT = AdamWConfig(lr=1e-3)
#: the reference test's reduced olmo-1b, its batch and its mesh
OLMO = dict(n_layers=2, d_model=64, d_ff=128, n_heads=2, kv_heads=2,
            head_dim=32)


class FakeMesh:
    """Duck-typed mesh: axis sizes and a device type, no process group."""

    def __init__(self, **shape):
        self.shape = shape
        self.device_type = "cpu"


def _batch(cfg, seq, batch, seed=0):
    ds = SyntheticDataset(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                          seed=seed, family=cfg.family,
                          n_frontend_tokens=cfg.n_frontend_tokens,
                          d_model=cfg.d_model, dtype=cfg.dtype, device="cpu")
    return ds.batch_at(0)


def _single_device_step(cfg, seq, batch):
    state0 = adamw_init(Model(cfg, device="cpu").init(seed=0))
    return make_train_step(Model(cfg, device="cpu"), OPT)(
        state0, _batch(cfg, seq, batch))


def _assert_matches_single_device(cfg, seq, batch, got):
    ref_state, ref_m = _single_device_step(cfg, seq, batch)
    np.testing.assert_allclose(got["loss"], float(ref_m["loss"]),
                               rtol=LOSS_RTOL)
    # Adam's first step moves each parameter by about lr whatever its
    # gradient's size, so the gradients are held by their global norm
    np.testing.assert_allclose(got["grad_norm"], float(ref_m["grad_norm"]),
                               rtol=GRAD_NORM_RTOL)
    ref = tree_leaves(ref_state["params"])
    assert len(got["params"]) == len(ref)
    for a, b in zip(got["params"], ref):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   **PARAM_TOL)


# --------------------------------------------------------------------------
# the int8 gradient sync
# --------------------------------------------------------------------------

def test_quantize_roundtrip_bounds():
    from repro.distributed.collectives import quantize_int8 as ref_quantize
    x = np.random.default_rng(0).standard_normal(256).astype(np.float32) * 3
    q, scale = quantize_int8(torch.from_numpy(x))
    err = np.abs(dequantize_int8(q, scale).numpy() - x)
    assert err.max() <= float(scale) / 2 + 1e-6
    ref_q, ref_scale = ref_quantize(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    assert float(scale) == float(ref_scale)


def _ref_int8_sync(inputs, out):
    """The reference's cross_pod_grad_sync and psum_int8 under shard_map
    over a 2-device ``pod`` mesh, as tests/test_distributed.py runs it."""
    code = f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from jax.experimental.shard_map import shard_map
        from repro.distributed.collectives import (cross_pod_grad_sync,
                                                   psum_int8)
        d = np.load({str(inputs)!r})
        g = {{"w": jnp.asarray(d["g_w"]),
             "b": jnp.asarray(d["g_b"]).astype(jnp.bfloat16)}}
        e = {{"w": jnp.asarray(d["e_w"]), "b": jnp.asarray(d["e_b"])}}

        def f(gs, es):
            s, ne = cross_pod_grad_sync(gs, es, "pod")
            s0, ne0 = cross_pod_grad_sync(gs, None, "pod")
            return s, ne, s0, ne0, psum_int8(gs, "pod")

        spec = {{"w": P("pod"), "b": P("pod")}}
        fn = shard_map(f, mesh=jax.make_mesh((2,), ("pod",)),
                       in_specs=(spec, spec), out_specs=(spec,) * 5,
                       check_rep=False)
        outs = fn(g, e)
        np.savez({str(out)!r}, **{{f"{{i}}_{{k}}": np.asarray(
            o[k].astype(jnp.float32)) for i, o in enumerate(outs) for k in o}})
    """
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return np.load(out)


def test_int8_psum_with_error_feedback_matches_reference(tmp_path):
    """Two pods, one row each, fp32 and bf16 leaves, with and without an
    error to feed back: the synced means and the new errors equal the
    reference's bit for bit, and so does psum_int8."""
    rng = np.random.default_rng(0)
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, g_w=rng.standard_normal((2, 64), np.float32) * 3,
             g_b=rng.standard_normal((2, 32), np.float32),
             e_w=rng.standard_normal((2, 64), np.float32) * 0.01,
             e_b=rng.standard_normal((2, 32), np.float32) * 0.01)
    ref = _ref_int8_sync(inputs, tmp_path / "ref.npz")
    out = run_ranks(f"""
        import numpy as np
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.distributed.collectives import (
            cross_pod_grad_sync, psum_int8)
        d = np.load({str(inputs)!r})
        row = lambda k: torch.from_numpy(d[k][RANK:RANK + 1])
        g = {{"w": row("g_w"), "b": row("g_b").to(torch.bfloat16)}}
        e = {{"w": row("e_w"), "b": row("e_b")}}
        group = init_device_mesh("cpu", (2,), mesh_dim_names=("pod",)) \\
            .get_group("pod")
        outs = (*cross_pod_grad_sync(g, e, group),
                *cross_pod_grad_sync(g, None, group), psum_int8(g, group))
        np.savez(f"{{OUT}}/rank{{RANK}}.npz", **{{
            f"{{i}}_{{k}}": o[k].float().numpy()
            for i, o in enumerate(outs) for k in o}})
    """, 2, tmp_path)
    ranks = [np.load(out / f"rank{r}.npz") for r in range(2)]
    assert sorted(ranks[0].files) == sorted(ref.files)
    for key in ref.files:
        np.testing.assert_array_equal(
            np.concatenate([r[key] for r in ranks]), ref[key], err_msg=key)


def test_make_compressed_sync_none_without_pod():
    assert make_compressed_sync(FakeMesh(data=2, model=4)) is None
    assert make_compressed_sync(FakeMesh(pod=1, data=16, model=16)) is None


def test_compressed_sync_over_pods_of_dtensor_grads(tmp_path):
    """On a (pod=2, data=2) mesh: gradients sharded over (pod, data), or
    replicated, are replicated over the pods, synced and put back; each
    equals the quantize-dequantize of the whole gradient bit for bit, the
    error what it dropped. Then the sync as make_train_step's
    grad_transform, carrying its error from step to step."""
    out = run_ranks(f"""
        from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                              distribute_tensor)
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        from repro_torch.configs import reduced_config
        from repro_torch.distributed.collectives import make_compressed_sync
        from repro_torch.distributed.sharding import (
            FSDP_RULES, activation_sharding, distribute_tree, tree_shardings)
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models.model import Model
        from repro_torch.models.transformer import tree_map
        from repro_torch.training.data import SyntheticDataset
        from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                    train_state_axes)
        from repro_torch.training.train_step import make_train_step
        mesh = make_test_mesh((2, 2), ("pod", "data"), device_type="cpu")
        sync = make_compressed_sync(mesh)
        gen = torch.Generator().manual_seed(0)
        g = {{"w": torch.randn(8, 16, generator=gen) * 3,
             "b": torch.randn(16, generator=gen).to(torch.bfloat16)}}
        place = {{"w": (Shard(0), Shard(0)), "b": (Replicate(), Replicate())}}
        dg = {{k: distribute_tensor(v, mesh, place[k]) for k, v in g.items()}}
        s1, e1 = sync(dg, None)
        s2, e2 = sync(dg, e1)
        assert all(s1[k].placements == place[k] == e1[k].placements
                   for k in g)
        full = lambda tree: {{k: v.full_tensor() for k, v in tree.items()}}
        res = dict(g=g, s1=full(s1), e1=full(e1), s2=full(s2), e2=full(e2))

        cfg = reduced_config("olmo-1b", **{OLMO!r})
        model = Model(cfg, device="cpu")
        params, axes = model.build(seed=0)
        state = adamw_init(params)
        state = distribute_tree(state, tree_shardings(
            mesh, FSDP_RULES, train_state_axes(axes), state))
        seen, err = [], [None]

        def grad_transform(grads):
            synced, err[0] = sync(grads, err[0])
            seen.append((tree_map(lambda t: t.full_tensor(), grads),
                         tree_map(lambda t: t.full_tensor(), synced)))
            return synced

        step = make_train_step(model, AdamWConfig(lr=1e-3),
                               grad_transform=grad_transform)
        ds = SyntheticDataset(vocab=cfg.vocab, seq_len=16, global_batch=8,
                              device="cpu")
        for i in range(2):
            batch = {{k: distribute_tensor(v, mesh, (Shard(0), Shard(0)))
                     for k, v in ds.batch_at(i).items()}}
            with activation_sharding(mesh, FSDP_RULES), implicit_replication():
                state, m = step(state, batch)
        res["train"] = seen
        res["loss"] = float(m["loss"].full_tensor())
        if RANK == 0:
            torch.save(res, f"{{OUT}}/sync.pt")
    """, 4, tmp_path)
    res = torch.load(out / "sync.pt")

    def qdq(x):
        return dequantize_int8(*quantize_int8(x))

    for k, g in res["g"].items():
        want1 = qdq(g)
        assert torch.equal(res["s1"][k], want1.to(g.dtype))
        assert torch.equal(res["e1"][k], g.float() - want1)
        g2 = (g.float() + res["e1"][k]).to(g.dtype)
        want2 = qdq(g2)
        assert torch.equal(res["s2"][k], want2.to(g.dtype))
        assert torch.equal(res["e2"][k], g2.float() - want2)
    assert len(res["train"]) == 2 and np.isfinite(res["loss"])
    err = None
    for grads, synced in res["train"]:
        flat_g, flat_s = tree_leaves(grads), tree_leaves(synced)
        if err is not None:
            flat_g = [(g.float() + e).to(g.dtype)
                      for g, e in zip(flat_g, err)]
        err = []
        for g, s in zip(flat_g, flat_s):
            want = qdq(g)
            assert torch.equal(s, want.to(g.dtype))
            err.append(g.float() - want)


# --------------------------------------------------------------------------
# the sharded train step
# --------------------------------------------------------------------------

def test_build_train_step_inputs_on_a_fake_mesh():
    cfg = reduced_config("olmo-1b", **OLMO)
    bundle = build_train_step(cfg, Shape("t", 16, 8, "train"),
                              FakeMesh(data=2, model=4))
    state_specs, batch_specs = bundle.in_specs
    state_sh, batch_sh = bundle.in_shardings
    assert all(t.device.type == "meta" for t in tree_leaves(state_specs))
    assert tuple(batch_specs["tokens"].shape) == (8, 16)
    assert bundle.model.device.type == "cpu" and bundle.kind == "train"
    from torch.distributed.tensor import Replicate, Shard
    assert batch_sh["tokens"].placements == (Shard(0), Replicate())
    assert state_sh["params"]["embed"]["tok"].placements == \
        (Shard(1), Shard(0))
    assert state_sh["step"].placements == (Replicate(), Replicate())


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_build_step_refuses_serving_steps(kind):
    """The serving steps are built now (tests/test_torch_serve_steps.py
    runs them); build_step refuses only a kind it does not know."""
    cfg = reduced_config("qwen3-0.6b")
    with pytest.raises(ValueError, match="unknown step kind"):
        build_step(cfg, Shape("s", 64, 2, kind + "_x"), FakeMesh(data=2))
    bundle = build_step(cfg, Shape("s", 64, 2, kind), FakeMesh(data=2))
    assert bundle.kind == kind


#: the rank code that runs build_train_step's step from seed-0 weights on
#: one seed-0 batch and saves the loss and the whole new params (rank 0)
_SHARDED_STEP = """
    from repro_torch.configs import reduced_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.training.data import SyntheticDataset
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    mesh = make_test_mesh(MESH, device_type="cpu")
    for name, (arch, over, seq, batch) in CASES.items():
        cfg = reduced_config(arch, **over)
        bundle = build_train_step(cfg, Shape("t", seq, batch, "train"), mesh,
                                  opt_cfg=AdamWConfig(lr=1e-3), donate=False)
        state0 = adamw_init(Model(cfg, device="cpu").init(seed=0))
        ds = SyntheticDataset(vocab=cfg.vocab, seq_len=seq,
                              global_batch=batch, family=cfg.family,
                              n_frontend_tokens=cfg.n_frontend_tokens,
                              d_model=cfg.d_model, dtype=cfg.dtype,
                              device="cpu")
        state, batch = bundle.place(state0, ds.batch_at(0))
        new, m = bundle.step(state, batch)
        same = [a.placements == b.placements for a, b in
                zip(tree_leaves(new), tree_leaves(state))]
        assert all(same), "the new state keeps the state's placements"
        res = dict(loss=float(m["loss"].full_tensor()),
                   grad_norm=float(m["grad_norm"].full_tensor()),
                   params=[p.full_tensor() for p in
                           tree_leaves(new["params"])])
        if RANK == 0:
            torch.save(res, f"{OUT}/{name}.pt")
"""


def test_sharded_train_step_matches_single_device(tmp_path):
    """8 ranks, a (data=2, model=4) mesh, FSDP rules: the reference
    test's reduced olmo-1b, batch 8 x 16, one step, against the port's
    single-device make_train_step from the same state."""
    cases = {"olmo": ("olmo-1b", OLMO, 16, 8)}
    out = run_ranks(f"MESH = (2, 4)\nCASES = {cases!r}\n"
                    + textwrap.dedent(_SHARDED_STEP), 8, tmp_path)
    got = torch.load(out / "olmo.pt")
    _assert_matches_single_device(reduced_config("olmo-1b", **OLMO), 16, 8,
                                  got)


#: one reduced arch of every other family (2 layers, so each has one
#: shared-attention application, one sLSTM block, one cross layer), and
#: qwen3 under the full configs' remat "dots", on a (data=2, model=2) mesh
FAMILY_CASES = {
    "qwen3-0.6b dots": ("qwen3-0.6b", dict(n_layers=2, remat="dots"), 16, 4),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", dict(n_layers=2), 16, 4),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", dict(n_layers=2), 16, 4),
    "zamba2-1.2b": ("zamba2-1.2b", dict(n_layers=2), 16, 4),
    "xlstm-350m": ("xlstm-350m", dict(n_layers=2), 16, 4),
    "whisper-tiny": ("whisper-tiny", dict(n_layers=2), 16, 4),
    "llama-3.2-vision-90b": ("llama-3.2-vision-90b", dict(n_layers=2), 16,
                             4),
}


@pytest.fixture(scope="module")
def family_steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    return run_ranks(f"MESH = (2, 2)\nCASES = {FAMILY_CASES!r}\n"
                     + textwrap.dedent(_SHARDED_STEP), 4, tmp,
                     timeout=240)


@pytest.mark.parametrize("name", list(FAMILY_CASES))
def test_sharded_train_step_other_families(family_steps, name):
    arch, over, seq, batch = FAMILY_CASES[name]
    got = torch.load(family_steps / f"{name}.pt")
    _assert_matches_single_device(reduced_config(arch, **over), seq, batch,
                                  got)


# --------------------------------------------------------------------------
# elastic resharding and sharded checkpoints
# --------------------------------------------------------------------------

def test_elastic_reshard_across_meshes(tmp_path):
    """A state sharded on a (4, 2) mesh moves onto (8, 1), (2, 4) and a
    (2, 2) mesh of half the ranks; every leaf is equal bit for bit and
    placed as the rules place it on the new mesh."""
    run_ranks(f"""
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.configs import reduced_config
        from repro_torch.distributed.fault_tolerance import elastic_reshard
        from repro_torch.distributed.sharding import (FSDP_RULES,
                                                      distribute_tree,
                                                      tree_shardings)
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models.model import Model
        from repro_torch.models.transformer import tree_leaves
        from repro_torch.training.optimizer import adamw_init, train_state_axes
        params, axes = Model(reduced_config("olmo-1b", **{OLMO!r}),
                             device="cpu").build(seed=0)
        state = adamw_init(params)
        st_axes = train_state_axes(axes)
        m1 = make_test_mesh((4, 2), device_type="cpu")
        state1 = distribute_tree(state, tree_shardings(m1, FSDP_RULES,
                                                       st_axes, state))
        half = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        for mesh in (make_test_mesh((8, 1), device_type="cpu"),
                     make_test_mesh((2, 4), device_type="cpu"), half):
            moved = elastic_reshard(state1, st_axes, mesh, FSDP_RULES)
            want = tree_shardings(mesh, FSDP_RULES, st_axes, state)
            for a, b, s in zip(tree_leaves(state), tree_leaves(moved),
                               tree_leaves(want)):
                assert b.device_mesh is mesh and b.placements == s.placements
                if mesh is not half or RANK < 4:
                    assert torch.equal(b.full_tensor(), a)
    """, 8, tmp_path)


def test_sharded_checkpoint_is_the_unsharded_files(tmp_path):
    """A state sharded on (2, 4) saves the same files, byte for byte, as
    the same state saved unsharded; it restores with ``shardings=`` onto
    a (4, 2) mesh bit for bit; and ResilientLoop, given the Shardings,
    restores a sharded run after a fault and ends where an uninterrupted
    run ends."""
    cfg = reduced_config("olmo-1b", **OLMO)
    state0 = adamw_init(Model(cfg, device="cpu").init(seed=0))
    save_checkpoint(str(tmp_path / "plain"), 7, state0, extra={"a": 1})
    out = run_ranks(f"""
        from repro_torch.configs import reduced_config
        from repro_torch.configs.shapes import Shape
        from repro_torch.distributed.fault_tolerance import (InjectedFault,
                                                             ResilientLoop)
        from repro_torch.distributed.sharding import (FSDP_RULES,
                                                      distribute_tree,
                                                      tree_shardings)
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.launch.steps import build_train_step
        from repro_torch.models.model import Model
        from repro_torch.models.transformer import tree_leaves
        from repro_torch.training.checkpoint import (restore_checkpoint,
                                                     save_checkpoint)
        from repro_torch.training.data import SyntheticDataset
        from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                    train_state_axes)
        cfg = reduced_config("olmo-1b", **{OLMO!r})
        model = Model(cfg, device="cpu")
        state = adamw_init(model.init(seed=0))
        st_axes = train_state_axes(model.param_axes())
        m24 = make_test_mesh((2, 4), device_type="cpu")
        m42 = make_test_mesh((4, 2), device_type="cpu")
        sh24 = tree_shardings(m24, FSDP_RULES, st_axes, state)
        sh42 = tree_shardings(m42, FSDP_RULES, st_axes, state)
        d24 = distribute_tree(state, sh24)
        save_checkpoint({str(tmp_path / "sharded")!r}, 7, d24,
                        extra={{"a": 1}})
        back, step, extra = restore_checkpoint({str(tmp_path / "sharded")!r},
                                               like=d24, shardings=sh42)
        assert step == 7 and extra == {{"a": 1}}
        for a, b, s in zip(tree_leaves(state), tree_leaves(back),
                           tree_leaves(sh42)):
            assert b.placements == s.placements and b.device_mesh is m42
            assert torch.equal(b.full_tensor(), a)

        bundle = build_train_step(cfg, Shape("t", 16, 8, "train"), m24,
                                  opt_cfg=AdamWConfig(lr=1e-3))
        ds = SyntheticDataset(vocab=cfg.vocab, seq_len=16, global_batch=8,
                              device="cpu")
        batch_sh = bundle.in_shardings[1]

        class Placed:
            def batch_at(self, i):
                return distribute_tree(ds.batch_at(i), batch_sh)

        fired = []

        def fault(i):
            if i == 2 and not fired:
                fired.append(i)
                raise InjectedFault("injected at step 2")

        ends = {{}}
        for name, hook in (("clean", None), ("faulty", fault)):
            loop = ResilientLoop(bundle.step, d24,
                                 ckpt_dir={str(tmp_path)!r} + "/loop_" + name,
                                 ckpt_every=1, keep=2, fault_hook=hook,
                                 shardings=sh24)
            rep = loop.run(Placed(), until_step=3)
            ends[name] = (rep, [p.full_tensor() for p in
                                tree_leaves(loop.state)])
        assert ends["clean"][0].restores == 0 and ends["clean"][0].failures == 0
        assert ends["faulty"][0].restores == 1
        assert ends["faulty"][0].final_step == 3
        same = all(torch.equal(a, b) for a, b in
                   zip(ends["clean"][1], ends["faulty"][1]))
        assert same, "the restored run ends where the clean run ends"
    """, 8, tmp_path)
    plain = tmp_path / "plain" / "step_00000007"
    sharded = tmp_path / "sharded" / "step_00000007"
    names = sorted(os.listdir(plain))
    assert names == sorted(os.listdir(sharded))
    assert "manifest.json" in names and len(names) >= 2
    match, mismatch, errors = filecmp.cmpfiles(plain, sharded, names,
                                               shallow=False)
    assert mismatch == [] and errors == [] and match == names
    assert json.loads((plain / "manifest.json").read_text())["step"] == 7


# --------------------------------------------------------------------------
# production meshes
# --------------------------------------------------------------------------

def test_production_meshes_under_a_fake_process_group():
    code = """
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.distributed.sharding import mesh_axes
        from repro_torch.launch.mesh import describe, make_production_mesh
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512)
        m = make_production_mesh(multi_pod=True, device_type="cpu")
        assert mesh_axes(m) == {"pod": 2, "data": 16, "model": 16}, m
        assert describe(m) == "pod=2 x data=16 x model=16"
        dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=3,
                                world_size=256)
        m1 = make_production_mesh(device_type="cpu")
        assert mesh_axes(m1) == {"data": 16, "model": 16}
        assert list(m1.get_coordinate()) == [0, 3]
        dist.destroy_process_group()
        print("OK")
    """
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-4000:]
