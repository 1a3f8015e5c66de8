"""The xLSTM, whisper and llama-vision families of the port against the
JAX package at their reduced size (fp32), beyond what
tests/test_torch_model.py holds for every arch: the params the port draws
itself, loss and one AdamW step, the serving engine, checkpoints across
the two packages, the dataset's frames and patches, and the errors. The
vision model's gates are opened (0.5, -0.75) in every comparison."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as ref_registry
from repro.models.model import Model as RefModel
from repro.serving import RequestQueue as RefQueue
from repro.serving import ServeEngine as RefEngine
from repro.training import checkpoint as ref_ckpt
from repro.training import data as ref_data
from repro.training import optimizer as ref_opt
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_leaves
from repro_torch.serving import RequestQueue, ServeEngine
from repro_torch.training import (AdamWConfig, SyntheticDataset, adamw_init,
                                  make_train_step, restore_checkpoint,
                                  save_checkpoint)

ARCHS = ("xlstm-350m", "whisper-tiny", "llama-3.2-vision-90b")
#: loss and gradient tolerance of the reference (tests/test_training.py)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
GATES = {"gate_attn": 0.5, "gate_mlp": -0.75}
LR = 1e-3


def _open_gates(ref_params):
    if "segments" not in ref_params:
        return ref_params
    seg = ref_params["segments"]
    cross = dict(seg["cross"], **{k: jnp.full_like(seg["cross"][k], v)
                                  for k, v in GATES.items()})
    return dict(ref_params, segments=dict(seg, cross=cross))


def _pair(arch, **overrides):
    """(port model, reference model, port params, reference params)."""
    ref_model = RefModel(ref_registry.reduced_config(arch, **overrides))
    ref_params = _open_gates(ref_model.init(jax.random.key(0)))
    port = Model(reduced_config(arch, **overrides), device="cpu")
    params = bridge.from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return port, ref_model, params, ref_params


def _ref_batch(cfg, seq=16, batch=4):
    """The reference dataset's batch (tokens, labels and the frames or
    patches of the family) as numpy."""
    ds = ref_data.SyntheticDataset(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, family=cfg.family,
        n_frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model,
        dtype=cfg.dtype)
    return {k: np.asarray(v, np.int64 if k in ("tokens", "labels")
                          else np.float32)
            for k, v in ds.batch_at(0).items()}


def _jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
            for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _stub(cfg):
    """A batch-1 frames / patches input for the engine, or nothing."""
    name = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if name is None:
        return {}
    return {name: np.random.default_rng(4).standard_normal(
        (1, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_structure(arch):
    """The params the port draws itself have the reference's tree (the
    xLSTM layers a list, the vision self layers stacked over (segments,
    layers)), shapes and types; fresh vision gates are closed."""
    port = Model(reduced_config(arch), device="cpu")
    got = bridge.to_numpy(port.init(seed=0))
    want = jax.eval_shape(RefModel(ref_registry.reduced_config(arch)).init,
                          jax.random.key(0))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    if arch.startswith("llama"):
        nseg = port.cfg.n_layers // port.cfg.cross_attn_every
        assert got["segments"]["self"]["attn"]["wq"].shape[:2] == (nseg, 1)
        assert not got["segments"]["cross"]["gate_attn"].any()
    if arch.startswith("xlstm"):
        assert isinstance(got["layers"], list)


@pytest.fixture(scope="module")
def reference_steps():
    """Per arch: the reference's params and batch (every fifth label
    masked), and its state and metrics after one jitted AdamW step of
    make_train_step."""
    out = {}
    for arch in ARCHS:
        _, ref_model, _, ref_params = _pair(arch)
        batch = _ref_batch(ref_model.cfg)
        batch["labels"][:, ::5] = -1
        step = jax.jit(ref_make_train_step(ref_model,
                                           ref_opt.AdamWConfig(lr=LR)))
        state, metrics = step(ref_opt.adamw_init(ref_params), _jax(batch))
        out[arch] = dict(params=ref_params, batch=batch, state=state,
                         metrics={k: float(v) for k, v in metrics.items()})
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "dots"])
def test_adamw_step_matches_reference(reference_steps, arch, remat):
    """One make_train_step step from the reference's params on its batch:
    the loss (Model.loss over the unmasked labels), ce and grad norm at
    the gradient tolerance, the first moment
    (0.1 x the clipped gradient) too, and the params within 2 lr: Adam's
    first step moves each element by about +-lr, whose sign a gradient
    near 0 may flip."""
    ref = reference_steps[arch]
    model = Model(reduced_config(arch, remat=remat), device="cpu")
    params = bridge.from_reference(jax.tree.map(np.asarray, ref["params"]),
                                   device="cpu")
    state, metrics = make_train_step(model, AdamWConfig(lr=LR))(
        adamw_init(params), _torch(ref["batch"]))
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), ref["metrics"][k],
                                   **GRAD_TOL, err_msg=k)
    for got, want in zip(jax.tree.leaves(bridge.to_numpy(state["m"])),
                         jax.tree.leaves(ref["state"]["m"])):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6,
                                   rtol=1e-4)
    for got, want in zip(jax.tree.leaves(bridge.to_numpy(state["params"])),
                         jax.tree.leaves(ref["state"]["params"])):
        assert float(np.abs(got - np.asarray(want)).max()) <= 2 * LR + 1e-6
    assert int(state["step"]) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_reference_engine(arch):
    """Both engines serve the same prompts, a batch-1 frames / patches
    input passed through admission as ``extra_inputs``."""
    port, ref_model, params, ref_params = _pair(arch)
    extra = _stub(port.cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, port.cfg.vocab, size=n) for n in (5, 9, 3)]
    ref_q, port_q = RefQueue(), RequestQueue()
    for prompt in prompts:
        ref_q.submit(prompt, max_new_tokens=6)
        port_q.submit(prompt, max_new_tokens=6)
    want = RefEngine(ref_model, ref_params, n_slots=2, max_len=32).run(
        ref_q, extra_inputs={k: jnp.asarray(v) for k, v in extra.items()})
    engine = ServeEngine(port, params, n_slots=2, max_len=32)
    got = engine.run(port_q, extra_inputs={k: torch.from_numpy(v)
                                           for k, v in extra.items()})
    assert {r.uid: r.tokens for r in got} == {r.uid: r.tokens for r in want}
    assert engine.n_prefills == 3


def _ref_xlstm_state():
    """A reference TrainState of reduced xlstm-350m (2 layers: one mLSTM,
    one sLSTM) with random moments and step 5."""
    cfg = ref_registry.reduced_config("xlstm-350m", n_layers=2)
    state = ref_opt.adamw_init(RefModel(cfg).init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    noise = lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype)
    state["m"] = jax.tree.map(noise, state["m"])
    state["v"] = jax.tree.map(lambda x: jnp.abs(noise(x)), state["v"])
    state["step"] = jnp.asarray(5, jnp.int32)
    return state


def _manifest_paths(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return [e["path"] for e in json.load(f)["leaves"]]


def test_xlstm_checkpoints_cross_between_the_packages(tmp_path):
    """The reference's checkpoint of an xLSTM state (a list of layers)
    restores in the port bit for bit, and the port's in the reference;
    both write the same leaf paths, ``jax.tree_util.keystr``'s."""
    ref_state = _ref_xlstm_state()
    want = bridge.from_reference(jax.tree.map(np.asarray, ref_state),
                                 device="cpu")
    assert isinstance(want["params"]["layers"], list)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save_checkpoint(ref_dir, 5, ref_state)
    save_checkpoint(port_dir, 5, want)
    keystrs = [jax.tree_util.keystr(p) for p, _ in
               jax.tree_util.tree_flatten_with_path(ref_state)[0]]
    assert "['params']['layers'][0]['block']['up']" in keystrs
    assert _manifest_paths(ref_dir, 5) == _manifest_paths(port_dir, 5) \
        == keystrs

    got, step, _ = restore_checkpoint(ref_dir, like=want)
    assert step == 5
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back, step, _ = ref_ckpt.restore_checkpoint(port_dir, like=ref_state)
    assert step == 5
    assert jax.tree.structure(back) == jax.tree.structure(ref_state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("family,name", [("audio", "frames"),
                                         ("vlm", "patches")])
def test_dataset_draws_frames_and_patches(family, name):
    """The stub frontend's input comes from the (seed, step, host) stream
    after the tokens, which stay the dense family's."""
    kw = dict(vocab=100, seq_len=8, global_batch=4, n_frontend_tokens=6,
              d_model=16, dtype="float32", device="cpu")
    ds = SyntheticDataset(family=family, **kw)
    b1, b2 = ds.batch_at(3), ds.batch_at(3)
    assert b1[name].shape == (4, 6, 16) and b1[name].dtype == torch.float32
    assert torch.equal(b1[name], b2[name])
    assert not torch.equal(b1[name], ds.batch_at(4)[name])
    h1 = ds.batch_at(3, host_index=1, host_count=2)
    assert h1[name].shape == (2, 6, 16)
    assert not torch.equal(h1[name], b1[name][:2])
    dense = SyntheticDataset(**kw).batch_at(3)
    assert sorted(dense) == ["labels", "tokens"]
    assert torch.equal(dense["tokens"], b1["tokens"])
    bf16 = dataclasses.replace(ds, dtype="bfloat16").batch_at(3)[name]
    assert bf16.dtype == torch.bfloat16


def test_xlstm_prompt_not_divisible_by_chunk_raises_like_reference():
    """Prefill takes the chunkwise mLSTM form, whose chunk (128) must
    divide a prompt longer than it: the reference asserts, the port
    raises ValueError with the reference's message."""
    port, ref_model, params, ref_params = _pair("xlstm-350m", n_layers=2)
    tokens = np.zeros((1, 130), np.int64)
    with pytest.raises(AssertionError, match="not divisible by chunk 128"):
        ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)},
                          max_len=140)
    with pytest.raises(ValueError, match="seq 130 not divisible by chunk 128"):
        port.prefill(params, {"tokens": torch.from_numpy(tokens)},
                     max_len=140)


def test_vlm_depth_must_be_whole_segments():
    cfg = reduced_config("llama-3.2-vision-90b", n_layers=5)
    with pytest.raises(ValueError, match="cross cadence"):
        Model(cfg, device="cpu").init(seed=0)
