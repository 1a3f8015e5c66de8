"""The port's xLSTM blocks against ``repro.models.xlstm``, function by
function, on the same numpy inputs and bridged weights (fp32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.models import xlstm as ref_xl
from repro_torch import bridge
from repro_torch.models import xlstm as xl

#: fp32 throughout. The forms differ from the reference's in summation
#: order only (torch's cumsum of the log forget gates against XLA's, and
#: the einsum contraction orders); a cumsum over a few hundred steps moves
#: the exponents by ~1e-6, so outputs of order one sit within this
TOL = dict(atol=1e-5, rtol=1e-5)
#: the matrix memory C and normaliser n sum up to a few hundred outer
#: products of order one: their absolute error scales with their size
STATE_TOL = dict(atol=1e-4, rtol=1e-5)
CFG = xl.XLSTMConfig(n_heads=4, expand=2, conv_kernel=4, slstm_every=2)
REF_CFG = ref_xl.XLSTMConfig(n_heads=4, expand=2, conv_kernel=4,
                             slstm_every=2)
D_MODEL = 32
#: the reference's functions, jitted: one compile per shape costs a tenth
#: of eager dispatch's compile per op
REF = {
    "conv": jax.jit(ref_xl._causal_conv),
    "parallel": jax.jit(ref_xl._mlstm_parallel),
    "chunked": jax.jit(ref_xl._mlstm_chunked, static_argnames="chunk"),
    "apply_mlstm": jax.jit(ref_xl.apply_mlstm, static_argnums=2),
    "with_state": jax.jit(ref_xl.apply_mlstm_with_state, static_argnums=2),
    "decode_mlstm": jax.jit(ref_xl.decode_mlstm, static_argnums=3),
    "slstm_step": jax.jit(ref_xl._slstm_step, static_argnums=1),
    "apply_slstm": jax.jit(ref_xl.apply_slstm, static_argnums=2),
    "decode_slstm": jax.jit(ref_xl.decode_slstm, static_argnums=3),
}


def _np(rng, *shape, shift=0.0):
    return (rng.standard_normal(shape) + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, msg=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], STATE_TOL, f"{msg}[{k}]")
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=msg, **tol)


def _params(kind, seed=0):
    """(reference params, bridged port params) of one block."""
    make = {"mlstm": ref_xl.make_mlstm_params,
            "slstm": ref_xl.make_slstm_params}[kind]
    ref, _ = make(jax.random.key(seed), D_MODEL, REF_CFG, jnp.float32)
    return ref, bridge.from_reference(jax.tree.map(np.asarray, ref),
                                      device="cpu")


def _qkv_gates(rng, b, s, h=2, d=16):
    """q, k, v and the gate pre-activations; the forget gates around the
    block's bias of +3, as a trained layer's."""
    return (_np(rng, b, s, h, d), _np(rng, b, s, h, d), _np(rng, b, s, h, d),
            _np(rng, b, s, h), _np(rng, b, s, h, shift=3.0))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_make_params_has_the_reference_layout(kind):
    ref, _ = _params(kind)
    make = {"mlstm": xl.make_mlstm_params, "slstm": xl.make_slstm_params}
    got = make[kind](torch.Generator().manual_seed(0), D_MODEL, CFG,
                     torch.float32, "cpu")
    want = jax.tree.map(np.asarray, ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype)[6:] == str(want[k].dtype), k
    # the gate biases are the reference's constants
    for k in ("b_if", "b_gates"):
        if k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_causal_conv():
    rng = np.random.default_rng(0)
    x, w = _np(rng, 2, 9, 8), _np(rng, 4, 8)
    _close(xl._causal_conv(_t(x), _t(w)),
           REF["conv"](jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("s", [1, 37, 128])
def test_mlstm_parallel(s):
    args = _qkv_gates(np.random.default_rng(s), 2, s)
    _close(xl._mlstm_parallel(*map(_t, args)),
           REF["parallel"](*map(jnp.asarray, args)))


@pytest.mark.parametrize("s,chunk", [(64, 64), (128, 32), (40, 128)])
@pytest.mark.parametrize("from_state", [False, True])
def test_mlstm_chunked(s, chunk, from_state):
    """From zeros and from a given state, over one chunk and several."""
    rng = np.random.default_rng(7)
    args = _qkv_gates(rng, 2, s)
    state0 = None
    if from_state:
        state0 = {"C": _np(rng, 2, 2, 16, 16), "n": _np(rng, 2, 2, 16),
                  "m": _np(rng, 2, 2)}
    got, got_st = xl._mlstm_chunked(
        *map(_t, args), chunk=chunk,
        state0=None if state0 is None else {k: _t(v) for k, v in
                                            state0.items()})
    want, want_st = REF["chunked"](
        *map(jnp.asarray, args), chunk=chunk,
        state0=None if state0 is None else jax.tree.map(jnp.asarray, state0))
    _close(got, want)
    _close(got_st, want_st)


@pytest.mark.parametrize("s,chunk", [(128, 128), (256, 64), (96, 32)])
def test_mlstm_parallel_and_chunked_forms_agree(s, chunk):
    args = tuple(map(_t, _qkv_gates(np.random.default_rng(3), 2, s)))
    np.testing.assert_allclose(
        xl._mlstm_chunked(*args, chunk=chunk)[0].numpy(),
        xl._mlstm_parallel(*args).numpy(), **TOL)


def test_mlstm_chunked_raises_like_the_reference():
    """A sequence longer than a chunk and not a multiple of it: the
    reference asserts, the port raises ValueError with its message."""
    args = _qkv_gates(np.random.default_rng(0), 1, 100)
    with pytest.raises(AssertionError, match="not divisible by chunk 64"):
        ref_xl._mlstm_chunked(*map(jnp.asarray, args), chunk=64)
    with pytest.raises(ValueError, match="seq 100 not divisible by chunk 64"):
        xl._mlstm_chunked(*map(_t, args), chunk=64)


@pytest.mark.parametrize("s", [48, xl.MLSTM_CHUNK_THRESHOLD + 128])
def test_apply_mlstm_on_both_sides_of_the_threshold(s):
    """The parallel form up to MLSTM_CHUNK_THRESHOLD, the chunkwise form
    above it."""
    assert xl.MLSTM_CHUNK_THRESHOLD == ref_xl.MLSTM_CHUNK_THRESHOLD == 512
    ref, params = _params("mlstm")
    x = _np(np.random.default_rng(s), 1, s, D_MODEL)
    _close(xl.apply_mlstm(params, _t(x), CFG),
           REF["apply_mlstm"](ref, jnp.asarray(x), REF_CFG))


@pytest.mark.parametrize("s", [2, 64])
def test_apply_mlstm_with_state(s):
    """The prefill entry point: output and decode-ready cache (a prompt
    shorter than the conv window pads it on the left)."""
    ref, params = _params("mlstm")
    x = _np(np.random.default_rng(1), 2, s, D_MODEL)
    got, got_c = xl.apply_mlstm_with_state(params, _t(x), CFG)
    want, want_c = REF["with_state"](ref, jnp.asarray(x), REF_CFG)
    _close(got, want)
    _close(got_c, want_c)


def test_decode_mlstm_continues_the_prefill():
    """decode_mlstm on the reference's own prefill cache (bridged) gives
    the reference's output and new cache, and writes it in place."""
    ref, params = _params("mlstm")
    rng = np.random.default_rng(2)
    x, x_new = _np(rng, 2, 32, D_MODEL), _np(rng, 2, 1, D_MODEL)
    _, ref_cache = REF["with_state"](ref, jnp.asarray(x), REF_CFG)
    cache = bridge.cache_from_reference(jax.tree.map(np.asarray, ref_cache),
                                        device="cpu")
    want, want_c = REF["decode_mlstm"](ref, jnp.asarray(x_new),
                                        ref_cache, REF_CFG)
    c_before = cache["C"]
    got, got_c = xl.decode_mlstm(params, _t(x_new), cache, CFG)
    _close(got, want)
    _close(got_c, want_c)
    assert got_c["C"] is c_before                 # updated in place


def test_decode_mlstm_from_an_empty_cache():
    ref, params = _params("mlstm")
    x = _np(np.random.default_rng(4), 3, 1, D_MODEL)
    cache = xl.init_mlstm_cache(3, D_MODEL, CFG, torch.float32, "cpu")
    want_cache = ref_xl.init_mlstm_cache(3, D_MODEL, REF_CFG, jnp.float32)
    _close(cache, jax.tree.map(np.asarray, want_cache))
    got, got_c = xl.decode_mlstm(params, _t(x), cache, CFG)
    want, want_c = REF["decode_mlstm"](ref, jnp.asarray(x), want_cache,
                                        REF_CFG)
    _close(got, want)
    _close(got_c, want_c)


def _slstm_state(rng, b):
    return {"c": _np(rng, b, 4, 8), "n": np.abs(_np(rng, b, 4, 8)) + 0.5,
            "h": _np(rng, b, 4, 8), "m": _np(rng, b, 4, 8)}


def test_slstm_step():
    ref, params = _params("slstm")
    rng = np.random.default_rng(5)
    state, wx = _slstm_state(rng, 2), _np(rng, 2, 4 * D_MODEL)
    _close(xl._slstm_step(params, CFG, {k: _t(v) for k, v in state.items()},
                          _t(wx)),
           REF["slstm_step"](ref, REF_CFG, jax.tree.map(jnp.asarray, state),
                              jnp.asarray(wx)))


@pytest.mark.parametrize("from_state", [False, True])
def test_apply_slstm(from_state):
    ref, params = _params("slstm")
    rng = np.random.default_rng(6)
    x = _np(rng, 2, 24, D_MODEL)
    state = _slstm_state(rng, 2) if from_state else None
    got, got_st = xl.apply_slstm(
        params, _t(x), CFG,
        None if state is None else {k: _t(v) for k, v in state.items()})
    want, want_st = REF["apply_slstm"](
        ref, jnp.asarray(x), REF_CFG,
        None if state is None else jax.tree.map(jnp.asarray, state))
    _close(got, want)
    _close(got_st, want_st)
    init = xl.init_slstm_state(2, D_MODEL, CFG, "cpu")
    _close(init, jax.tree.map(np.asarray,
                              ref_xl.init_slstm_state(2, D_MODEL, REF_CFG)))


def test_decode_slstm_is_one_step_of_apply():
    """decode_slstm against the reference, and against the port's own
    full-sequence recurrence one token later; the state is written in
    place."""
    ref, params = _params("slstm")
    rng = np.random.default_rng(8)
    x = _np(rng, 2, 9, D_MODEL)
    _, ref_state = REF["apply_slstm"](ref, jnp.asarray(x[:, :8]), REF_CFG)
    state = bridge.cache_from_reference(jax.tree.map(np.asarray, ref_state),
                                        device="cpu")
    want, want_st = REF["decode_slstm"](ref, jnp.asarray(x[:, 8:]),
                                         ref_state, REF_CFG)
    h_before = state["h"]
    got, got_st = xl.decode_slstm(params, _t(x[:, 8:]), state, CFG)
    _close(got, want)
    _close(got_st, want_st)
    assert got_st["h"] is h_before
    full, _ = xl.apply_slstm(params, _t(x), CFG)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, 8].numpy(), **TOL)
