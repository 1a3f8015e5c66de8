"""The port's Mamba2 block, SSD-scan ops and hybrid model (reduced zamba2)
against the JAX package on the same inputs and bridged weights. On the
CPU the SSD ops run their plain versions; the JAX kernels run in
interpret mode. The CUDA kernels are held against the same plain
versions on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as ref_registry
from repro.kernels.ssd_scan.kernel import ssd_inter as jax_ssd_inter
from repro.kernels.ssd_scan.kernel import ssd_intra as jax_ssd_intra
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.models import mamba2 as jax_m2
from repro.models.model import Model as RefModel
from repro.serving import RequestQueue as RefQueue
from repro.serving import ServeEngine as RefEngine
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (ssd_inter_ref, ssd_intra_ref,
                                              ssd_scan_naive, ssd_scan_ref)
from repro_torch.models import mamba2 as m2
from repro_torch.models.model import Model
from repro_torch.serving import RequestQueue, ServeEngine

#: tests/test_kernels.py's tolerances: outputs per dtype, and SSM states
TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
       "bfloat16": dict(atol=6e-2, rtol=6e-2)}
STATE_TOL = dict(atol=1e-3, rtol=1e-2)
#: model forward (test_kernels.py) and prefill/decode (test_serving.py)
FWD_TOL = dict(atol=2e-4, rtol=2e-3)
DEC_TOL = dict(atol=2e-3, rtol=2e-2)
#: tests/test_kernels.py::test_ssd_scan_sweep's (b, s, h, p, n, chunk)
SWEEP = [(2, 128, 4, 32, 16, 32), (1, 256, 8, 64, 64, 128),
         (2, 64, 2, 16, 8, 16)]
ARCH = "zamba2-1.2b"


def _both(x, dtype):
    """One numpy array as a torch and a JAX array of ``dtype``."""
    x = np.array(x, np.float32)
    return torch.from_numpy(x).to(getattr(torch, dtype)), \
        jnp.asarray(x).astype(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _scan_inputs(rng, b, s, h, p, n):
    """test_ssd_scan_sweep's distributions, drawn with numpy.

    ``log_a`` is rounded to a multiple of 2^-10, so every partial sum of
    a chunk is exact in fp32 and any cumsum order gives the same ``cum``.
    JAX's CPU cumsum and torch's round differently (by up to 1.5e-5 at
    q = 128), and exp(cum_i - cum_j) carries that into y by up to 2e-4:
    the grid keeps the comparison on the passes' own arithmetic.
    """
    xh = rng.standard_normal((b, s, h, p))
    bm = rng.standard_normal((b, s, n))
    cm = rng.standard_normal((b, s, n))
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0)
    log_a = -dt * np.exp(rng.standard_normal((b, s, h)) * 0.3)
    return xh, bm, cm, np.round(log_a * 1024) / 1024, dt


# --------------------------------------------------------------------------
# (a) the SSD-scan ops and their plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_pallas(b, s, h, p, n, chunk, dtype):
    xh, bm, cm, log_a, dt = _scan_inputs(np.random.default_rng(2),
                                         b, s, h, p, n)
    (txh, jxh), (tbm, jbm), (tcm, jcm) = (_both(a, dtype)
                                          for a in (xh, bm, cm))
    (tla, jla), (tdt, jdt) = (_both(a, "float32") for a in (log_a, dt))
    want_y, want_h = jax_ssd_scan(jxh, jbm, jcm, jla, jdt, chunk=chunk,
                                  interpret=True)
    before = (ssd_ops.intra_launches, ssd_ops.inter_launches)
    y, hf = ssd_ops.ssd_scan(txh, tbm, tcm, tla, tdt, chunk=chunk)
    assert (ssd_ops.intra_launches, ssd_ops.inter_launches) == before
    assert y.dtype == txh.dtype and hf.dtype == torch.float32
    _close(y, want_y, TOL[dtype])
    _close(hf, want_h, STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_from_h0_matches_pallas(b, s, h, p, n, chunk, dtype):
    """A given initial state: the port's inter pass runs the chunk
    recurrence from ``h0``, the reference's ``lax.scan`` starts from it."""
    rng = np.random.default_rng(8)
    xh, bm, cm, log_a, dt = _scan_inputs(rng, b, s, h, p, n)
    (txh, jxh), (tbm, jbm), (tcm, jcm) = (_both(a, dtype)
                                          for a in (xh, bm, cm))
    (tla, jla), (tdt, jdt), (th0, jh0) = (
        _both(a, "float32")
        for a in (log_a, dt, rng.standard_normal((b, h, n, p))))
    want_y, want_h = jax_ssd_scan(jxh, jbm, jcm, jla, jdt, chunk=chunk,
                                  interpret=True, h0=jh0)
    y, hf = ssd_ops.ssd_scan(txh, tbm, tcm, tla, tdt, chunk=chunk, h0=th0)
    assert y.dtype == txh.dtype and hf.dtype == torch.float32
    _close(y, want_y, TOL[dtype])
    _close(hf, want_h, STATE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_inter_op_is_recurrence_then_plain_pass(dtype, with_h0):
    """On a CPU tensor ``ops.ssd_inter`` runs ``ssd_inter_scan_ref``, the
    plain version the CUDA inter pass is held against: exactly
    ``chunk_recurrence`` followed by ``ssd_inter_ref``."""
    b, c, q, h, p, n = 2, 3, 16, 4, 16, 8
    rng = np.random.default_rng(9)
    f32 = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    cm = f32(b, c, q, n).to(getattr(torch, dtype))
    cum = torch.from_numpy(np.cumsum(-rng.random((b, c, q, h)),
                                     axis=2).astype(np.float32))
    s_chunk, y_intra = f32(b, c, h, n, p), f32(b, c, q, h, p)
    dec = torch.exp(cum[:, :, -1])
    h0 = f32(b, h, n, p) if with_h0 else None
    out_dtype = getattr(torch, dtype)
    before = ssd_ops.inter_launches
    y, h_last = ssd_ops.ssd_inter(cm, cum, s_chunk, dec, y_intra, out_dtype,
                                  h0)
    assert ssd_ops.inter_launches == before      # no kernel on the CPU
    h_prevs, want_h = m2.chunk_recurrence(s_chunk, dec, h0)
    want_y = ssd_inter_ref(cm, cum, h_prevs, y_intra, out_dtype)
    assert y.dtype == out_dtype and h_last.dtype == torch.float32
    assert torch.equal(y, want_y) and torch.equal(h_last, want_h)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_passes_match_pallas_bodies(b, s, h, p, n, chunk, dtype):
    """Each plain pass against its Pallas kernel on the same inputs."""
    rng = np.random.default_rng(5)
    xh, bm, cm, log_a, dt = _scan_inputs(rng, b, s, h, p, n)
    c, q = s // chunk, chunk
    (txh, jxh), (tbm, jbm), (tcm, jcm) = (
        _both(a.reshape(b, c, q, *a.shape[2:]), dtype) for a in (xh, bm, cm))
    cum = np.cumsum(log_a.reshape(b, c, q, h), axis=2)
    (tcum, jcum), (tdt, jdt) = (_both(a, "float32")
                                for a in (cum, dt.reshape(b, c, q, h)))
    want = jax_ssd_intra(jxh, jbm, jcm, jcum, jdt, interpret=True)
    got = ssd_intra_ref(txh, tbm, tcm, tcum, tdt)
    for g, w, tol in zip(got, want, (TOL["float32"], STATE_TOL,
                                     TOL["float32"])):
        assert g.dtype == torch.float32
        _close(g, w, tol)
    hprev = rng.standard_normal((b, c, h, n, p))
    (thp, jhp), (tyi, jyi) = (_both(a, "float32")
                              for a in (hprev, np.asarray(want[0])))
    want_y = jax_ssd_inter(jcm, jcum, jhp, jyi, jnp.dtype(dtype),
                           interpret=True)
    got_y = ssd_inter_ref(tcm, tcum, thp, tyi, getattr(torch, dtype))
    assert got_y.dtype == getattr(torch, dtype)
    _close(got_y, want_y, TOL[dtype])


@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_op_folds_the_cumsum(b, s, h, p, n, chunk, dtype):
    """``ops.ssd_intra`` takes ``log_a`` and returns the Pallas kernel's
    three outputs on ``jnp.cumsum(log_a)`` plus that cumsum."""
    rng = np.random.default_rng(7)
    xh, bm, cm, log_a, dt = _scan_inputs(rng, b, s, h, p, n)
    c, q = s // chunk, chunk
    (txh, jxh), (tbm, jbm), (tcm, jcm) = (
        _both(a.reshape(b, c, q, *a.shape[2:]), dtype) for a in (xh, bm, cm))
    (tla, jla), (tdt, jdt) = (_both(a.reshape(b, c, q, h), "float32")
                              for a in (log_a, dt))
    jcum = jnp.cumsum(jla, axis=2)
    want = jax_ssd_intra(jxh, jbm, jcm, jcum, jdt, interpret=True)
    before = ssd_ops.intra_launches
    got = ssd_ops.ssd_intra(txh, tbm, tcm, tla, tdt)
    assert ssd_ops.intra_launches == before      # no kernel on the CPU
    assert len(got) == 4 and all(g.dtype == torch.float32 for g in got)
    for g, w, tol in zip(got, (*want, jcum), (TOL["float32"], STATE_TOL,
                                              TOL["float32"],
                                              TOL["float32"])):
        _close(g, w, tol)


def test_ssd_chunked_ref_matches_naive_recurrence():
    """tests/test_kernels.py::test_ssd_chunked_ref_matches_naive_recurrence
    on the port's own oracles."""
    xh, bm, cm, log_a, dt = (torch.from_numpy(a.astype(np.float32)) for a in
                             _scan_inputs(np.random.default_rng(3),
                                          2, 96, 2, 16, 8))
    yr, hr = ssd_scan_ref(xh, bm, cm, log_a, dt, chunk=32)
    yn, hn = ssd_scan_naive(xh, bm, cm, log_a, dt)
    np.testing.assert_allclose(yr.numpy(), yn.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(hr.numpy(), hn.numpy(), atol=1e-4, rtol=1e-3)


# --------------------------------------------------------------------------
# (b) the Mamba2 block on bridged weights
# --------------------------------------------------------------------------

def _block(dtype):
    """(ssm config, port params, reference params, port cfg) of reduced
    zamba2's Mamba2 block."""
    cfg = reduced_config(ARCH)
    ref_cfg = ref_registry.reduced_config(ARCH)
    ref_params, _ = jax_m2.make_mamba2_params(
        jax.random.key(0), cfg.d_model, ref_cfg.ssm, jnp.dtype(dtype))
    params = bridge.from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return cfg.ssm, ref_cfg.ssm, params, ref_params, cfg


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba2_matches_reference(use_kernel, dtype):
    ssm, ref_ssm, params, ref_params, cfg = _block(dtype)
    x, jx = _both(np.random.default_rng(0).standard_normal(
        (2, 64, cfg.d_model)), dtype)
    tol = FWD_TOL if dtype == "float32" else TOL[dtype]
    want = jax_m2.apply_mamba2(ref_params, jx, ref_ssm, use_kernel=use_kernel,
                               interpret=True)
    got = m2.apply_mamba2(params, x, ssm, use_kernel=use_kernel)
    assert got.dtype == x.dtype
    _close(got, want, tol)

    want, want_st = jax_m2.apply_mamba2_with_state(
        ref_params, jx, ref_ssm, use_kernel=use_kernel, interpret=True)
    got, st = m2.apply_mamba2_with_state(params, x, ssm,
                                         use_kernel=use_kernel)
    _close(got, want, tol)
    assert st["h"].dtype == st["conv"].dtype == x.dtype
    _close(st["h"], want_st["h"], STATE_TOL if dtype == "float32" else tol)
    _close(st["conv"], want_st["conv"], tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_mamba2_matches_reference(dtype):
    ssm, ref_ssm, params, ref_params, cfg = _block(dtype)
    rng = np.random.default_rng(1)
    _, jprompt = _both(rng.standard_normal((2, 5, cfg.d_model)), dtype)
    _, ref_cache = jax_m2.apply_mamba2_with_state(ref_params, jprompt,
                                                  ref_ssm)
    cache = bridge.cache_from_reference(jax.tree.map(np.asarray, ref_cache),
                                        device="cpu")
    x, jx = _both(rng.standard_normal((2, 1, cfg.d_model)), dtype)
    want, want_c = jax_m2.decode_mamba2(ref_params, jx, ref_cache, ref_ssm)
    got, got_c = m2.decode_mamba2(params, x, cache, ssm)
    tol = DEC_TOL if dtype == "float32" else TOL[dtype]
    assert got.dtype == got_c["h"].dtype == x.dtype
    _close(got, want, tol)
    for k in ("h", "conv"):
        _close(got_c[k], want_c[k], tol)


# --------------------------------------------------------------------------
# (c)-(f) reduced zamba2
# --------------------------------------------------------------------------

def _pair(use_ssm_kernel=False, impl="plain", dtype="float32"):
    """(port model, reference model, port params, reference params)."""
    ref_impl = {"plain": "xla", "kernel": "pallas_interpret"}[impl]
    ref_model = RefModel(ref_registry.reduced_config(
        ARCH, attn_impl=ref_impl, use_ssm_kernel=use_ssm_kernel,
        dtype=dtype))
    ref_params = ref_model.init(jax.random.key(0))
    port = Model(reduced_config(ARCH, attn_impl=impl,
                                use_ssm_kernel=use_ssm_kernel, dtype=dtype),
                 device="cpu")
    params = bridge.from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return port, ref_model, params, ref_params


def _tokens(port, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, port.cfg.vocab, (b, s))


@pytest.mark.parametrize("use_ssm_kernel,impl", [(False, "plain"),
                                                 (True, "kernel")])
def test_hybrid_forward_matches_reference(use_ssm_kernel, impl):
    port, ref_model, params, ref_params = _pair(use_ssm_kernel, impl)
    tokens = _tokens(port, 2, 64)
    want, _ = ref_model.forward(ref_params, {"tokens": jnp.asarray(tokens)})
    before = ssd_ops.intra_launches
    got, aux = port.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert ssd_ops.intra_launches == before      # no kernel on the CPU
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("use_ssm_kernel", [False, True])
def test_hybrid_prefill_decode_matches_reference_and_forward(use_ssm_kernel):
    """Prefill over two chunks, then decode steps: logits and caches equal
    the reference's, and logits the port's own forward."""
    port, ref_model, params, ref_params = _pair(use_ssm_kernel)
    b, k, n = 2, 64, 68
    tokens = _tokens(port, b, 96)
    tt, jt = torch.from_numpy(tokens), jnp.asarray(tokens)
    full, _ = port.forward(params, {"tokens": tt})    # 3 whole chunks
    got, cache = port.prefill(params, {"tokens": tt[:, :k]}, max_len=n + 4)
    want, ref_cache = ref_model.prefill(ref_params, {"tokens": jt[:, :k]},
                                        max_len=n + 4)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, 0]),
                               **DEC_TOL)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, k - 1].numpy(),
                               **DEC_TOL)
    got_c, want_c = _flat(bridge.to_numpy(cache)), _flat(ref_cache)
    assert sorted(got_c) == sorted(want_c)
    for name in want_c:
        np.testing.assert_allclose(got_c[name], want_c[name], **DEC_TOL,
                                   err_msg=name)
    for i in range(k, n):
        got, cache = port.decode_step(params, cache, tt[:, i:i + 1])
        want, ref_cache = ref_model.decode_step(ref_params, ref_cache,
                                                jt[:, i:i + 1])
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, 0]),
                                   **DEC_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, i].numpy(),
                                   **DEC_TOL, err_msg=f"step {i}")
    got_c, want_c = _flat(bridge.to_numpy(cache)), _flat(ref_cache)
    for name in want_c:
        np.testing.assert_allclose(got_c[name], want_c[name], **DEC_TOL,
                                   err_msg=name)
    assert cache["length"].tolist() == [n] * b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_bridge_round_trip(dtype):
    port, _, params, ref_params = _pair(dtype=dtype)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params)
    got = bridge.to_numpy(params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)       # bf16 -> fp32 is exact
    mamba = params["layers"]["mamba"]
    assert mamba["x_proj"].dtype == getattr(torch, dtype)
    assert mamba["A_log"].dtype == torch.float32  # fp32 in any model dtype
    assert mamba["x_proj"].shape[0] == port.cfg.n_layers
    own = port.init(0)
    assert jax.tree.structure(bridge.to_numpy(own)) == \
        jax.tree.structure(want)
    assert all(o.shape == p.shape and o.dtype == p.dtype for o, p in
               zip(jax.tree.leaves(own), jax.tree.leaves(params)))


def test_prompt_not_divisible_by_chunk_raises_like_reference():
    """A 40-token prompt: the reference asserts, the port raises."""
    port, ref_model, params, ref_params = _pair(use_ssm_kernel=True)
    tokens = _tokens(port, 1, 40)
    with pytest.raises(AssertionError, match="seq 40 not divisible by "
                                             "chunk 32"):
        ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)},
                          max_len=48)
    for model in (port, Model(reduced_config(ARCH), device="cpu")):
        with pytest.raises(ValueError, match="seq 40 not divisible by "
                                             "chunk 32"):
            model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                          max_len=48)


@pytest.mark.parametrize("use_ssm_kernel", [False, True])
def test_engine_greedy_tokens_match_reference_engine(use_ssm_kernel):
    port, ref_model, params, ref_params = _pair(use_ssm_kernel)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, port.cfg.vocab, size=n) for n in (5, 9, 32)]
    ref_q, port_q = RefQueue(), RequestQueue()
    for prompt in prompts:
        ref_q.submit(prompt, max_new_tokens=6)
        port_q.submit(prompt, max_new_tokens=6)
    want = RefEngine(ref_model, ref_params, n_slots=2, max_len=48).run(ref_q)
    got = ServeEngine(port, params, n_slots=2, max_len=48).run(port_q)
    assert {r.uid: r.tokens for r in got} == {r.uid: r.tokens for r in want}
