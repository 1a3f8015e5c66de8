"""The port's checkpoints (atomic, the reference's on-disk format) and
its fault-tolerant loop; checkpoints cross between the two packages."""
import json
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.training import checkpoint as ref_ckpt
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.distributed.fault_tolerance import (InjectedFault,
                                                     ResilientLoop,
                                                     StepWatchdog)
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_leaves
from repro_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import make_train_step


def toy_state(dtype=torch.float32):
    return {"params": {"w": torch.arange(6.0).reshape(2, 3).to(dtype),
                       "b": torch.ones(3, dtype=dtype)},
            "m": {"w": torch.zeros((2, 3)), "b": torch.zeros(3)},
            "v": {"w": torch.zeros((2, 3)), "b": torch.zeros(3)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.device == b.device
        assert a.shape == b.shape and torch.equal(a, b)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_save_restore_roundtrip(tmp_path, dtype):
    d = str(tmp_path / "ckpt")
    state = toy_state(dtype)
    save_checkpoint(d, 7, state, extra={"note": "hi"})
    assert latest_step(d) == 7
    restored, step, extra = restore_checkpoint(d, like=state)
    assert step == 7 and extra == {"note": "hi"}
    _assert_states_equal(restored, state)


def test_incomplete_checkpoint_ignored(tmp_path):
    """A crash mid-write (no manifest) must be invisible to restore."""
    d = str(tmp_path / "ckpt")
    state = toy_state()
    save_checkpoint(d, 5, state)
    broken = os.path.join(d, "step_00000009")
    os.makedirs(broken)                   # dir exists, no manifest
    with open(os.path.join(broken, "shard_0.npz"), "wb") as f:
        f.write(b"garbage")
    assert latest_step(d) == 5
    _, step, _ = restore_checkpoint(d, like=state)
    assert step == 5


def test_keep_last_k(tmp_path):
    d = str(tmp_path / "ckpt")
    state = toy_state()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, state, keep=2)
    steps = sorted(int(n[5:]) for n in os.listdir(d))
    assert steps == [4, 5]


def test_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, toy_state())
    bad = toy_state()
    bad["params"]["w"] = torch.zeros((3, 3))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, like=bad)


def test_missing_leaf_rejected(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, toy_state())
    bigger = toy_state()
    bigger["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="extra"):
        restore_checkpoint(d, like=bigger)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), like=toy_state())


# --------------------------------------------------------------------------
# across the two packages
# --------------------------------------------------------------------------

def _ref_state(dtype):
    """A reference TrainState of reduced qwen3-0.6b with params in
    ``dtype`` (fp32 moments, int32 step)."""
    from repro.configs import registry as ref_registry
    from repro.models.model import Model as RefModel
    from repro.training.optimizer import adamw_init as ref_adamw_init
    cfg = ref_registry.reduced_config("qwen3-0.6b", n_layers=2, dtype=dtype)
    state = ref_adamw_init(RefModel(cfg).init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    noise = lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype)
    state["m"] = jax.tree.map(noise, state["m"])
    state["v"] = jax.tree.map(lambda x: jnp.abs(noise(x)), state["v"])
    state["step"] = jnp.asarray(11, jnp.int32)
    return state


def _bridged(ref_state):
    return bridge.from_reference(jax.tree.map(np.asarray, ref_state),
                                 device="cpu")


def test_reference_bf16_checkpoint_restores_in_port(tmp_path):
    """The reference writes bf16 leaves as raw 2-byte words; the port
    rebuilds them from the manifest's dtype, equal to the bridged state."""
    ref_state = _ref_state("bfloat16")
    d = str(tmp_path / "ref")
    ref_ckpt.save_checkpoint(d, 11, ref_state, extra={"by": "jax"})
    want = _bridged(ref_state)
    assert want["params"]["layers"]["attn"]["wq"].dtype == torch.bfloat16
    got, step, extra = restore_checkpoint(d, like=want)
    assert step == 11 and extra == {"by": "jax"}
    _assert_states_equal(got, want)


def test_port_fp32_checkpoint_restores_in_reference(tmp_path):
    ref_state = _ref_state("float32")
    d = str(tmp_path / "port")
    save_checkpoint(d, 11, _bridged(ref_state))
    got, step, _ = ref_ckpt.restore_checkpoint(d, like=ref_state)
    assert step == 11
    assert jax.tree.structure(got) == jax.tree.structure(ref_state)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_and_reference_write_the_same_bytes(tmp_path, dtype):
    """Same manifest and, member by member, the same .npy bytes; so the
    reference cannot misread a port file as numbers: on a bf16 leaf it
    fails as on its own file."""
    ref_state = _ref_state(dtype)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_path = ref_ckpt.save_checkpoint(ref_dir, 11, ref_state)
    port_path = save_checkpoint(port_dir, 11, _bridged(ref_state))
    manifests = []
    for path in (port_path, ref_path):
        with open(os.path.join(path, "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    assert sorted(os.listdir(port_path)) == sorted(os.listdir(ref_path))
    for name in os.listdir(ref_path):
        if name.endswith(".npz"):
            with zipfile.ZipFile(os.path.join(ref_path, name)) as r, \
                    zipfile.ZipFile(os.path.join(port_path, name)) as p:
                assert p.namelist() == r.namelist()
                for member in r.namelist():
                    assert p.read(member) == r.read(member), member
    if dtype == "bfloat16":
        for d in (ref_dir, port_dir):
            with pytest.raises(ValueError, match="cast"):
                ref_ckpt.restore_checkpoint(d, like=ref_state)


# --------------------------------------------------------------------------
# the resilient loop
# --------------------------------------------------------------------------

def make_loop_pieces(lr=1e-3):
    model = Model(reduced_config("olmo-1b", n_layers=2), device="cpu")
    state = adamw_init(model.init(seed=0))
    ds = SyntheticDataset(vocab=model.cfg.vocab, seq_len=16, global_batch=4,
                          device="cpu")
    return state, ds, make_train_step(model, AdamWConfig(lr=lr))


def test_resilient_loop_recovers_from_faults(tmp_path):
    state, ds, step = make_loop_pieces()
    failed = set()

    def fault_hook(step_idx):
        # fail once each at steps 7 and 13, after checkpoints exist
        if step_idx in (7, 13) and step_idx not in failed:
            failed.add(step_idx)
            raise InjectedFault(f"node died at step {step_idx}")

    loop = ResilientLoop(step, state, ckpt_dir=str(tmp_path / "ck"),
                         ckpt_every=5, fault_hook=fault_hook)
    report = loop.run(ds, until_step=20)
    assert report.final_step == 20
    assert report.failures == 2
    assert report.restores == 2
    assert latest_step(str(tmp_path / "ck")) == 20


def test_recovery_is_exactly_deterministic(tmp_path):
    """Loss trajectory after crash + restore == the uninterrupted one
    (step-keyed data, exact state restore)."""
    state, ds, step = make_loop_pieces()
    ref_losses = {}
    s = state
    for i in range(12):
        s, m = step(s, ds.batch_at(i))
        ref_losses[i] = float(m["loss"])

    seen = {}

    def record_step(st, batch):
        st2, m = step(st, batch)
        seen[int(st["step"])] = float(m["loss"])
        return st2, m

    failed = set()

    def fault_hook(i):
        if i == 8 and i not in failed:
            failed.add(i)
            raise InjectedFault("boom")

    loop = ResilientLoop(record_step, state, ckpt_dir=str(tmp_path / "ck2"),
                         ckpt_every=4, fault_hook=fault_hook)
    report = loop.run(ds, until_step=12)
    assert report.restores == 1 and report.failures == 1
    for i, loss in ref_losses.items():
        assert seen[i] == pytest.approx(loss, rel=1e-6), f"step {i}"
    # the final state equals the uninterrupted run's
    _assert_states_equal(loop.state, s)


def test_fault_before_any_checkpoint_propagates(tmp_path):
    state, ds, step = make_loop_pieces()

    def fault_hook(i):
        raise InjectedFault("died before the first checkpoint")

    loop = ResilientLoop(step, state, ckpt_dir=str(tmp_path / "ck3"),
                         ckpt_every=5, fault_hook=fault_hook)
    with pytest.raises(InjectedFault):
        loop.run(ds, until_step=3)
    assert loop.failures == 1 and loop.restores == 0


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(threshold=3.0, window=16)
    for i in range(10):
        wd.observe(i, 0.1)
    assert wd.observe(10, 0.5)           # 5x median -> straggler
    assert not wd.observe(11, 0.12)
    assert wd.straggler_steps == [10]
    assert wd.median == pytest.approx(0.1)
