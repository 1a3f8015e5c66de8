"""The port's layers against the JAX package's, on the same fp32 inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.models import layers as ref
from repro_torch.models import layers as port

#: fp32 layer tolerance: the kernels' fp32 tolerance (tests/test_kernels.py)
TOL = dict(atol=2e-5, rtol=2e-4)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _check(port_out, ref_out):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(ref_out), **TOL)


def test_rms_norm():
    x, w = _inputs(0, (2, 5, 64), (64,))
    _check(port.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           ref.rms_norm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("parametric", [True, False])
def test_layer_norm(parametric):
    x, w, b = _inputs(1, (2, 5, 64), (64,), (64,))
    if parametric:
        got = port.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b))
        want = ref.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    else:                                       # OLMo's non-parametric LN
        got = port.apply_norm({}, torch.from_numpy(x), "nonparametric")
        want = ref.apply_norm({}, jnp.asarray(x), "nonparametric")
    _check(got, want)


def test_apply_rope_split_half():
    (x,) = _inputs(2, (2, 7, 3, 32))
    pos = np.random.default_rng(3).integers(0, 500, (2, 7))
    _check(port.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           1_000_000.0),
           ref.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0))


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_apply_mlp(mlp):
    x, a, b, c, d = _inputs(4, (2, 5, 32), (32, 48), (32, 48), (48, 32),
                            (48,))
    params = ({"gate": a, "up": b, "down": c} if mlp == "swiglu" else
              {"up": a, "up_b": d, "down": c, "down_b": d[:32]})
    _check(port.apply_mlp({k: torch.from_numpy(v) for k, v in params.items()},
                          torch.from_numpy(x), mlp),
           ref.apply_mlp({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x), mlp))


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_unembed(tie):
    x, tok, out = _inputs(5, (2, 5, 32), (96, 32), (32, 96))
    params = {"tok": tok} if tie else {"tok": tok, "out": out}
    ids = np.random.default_rng(6).integers(0, 96, (2, 5))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    _check(port.embed_tokens(tp, torch.from_numpy(ids)),
           ref.embed_tokens(jp, jnp.asarray(ids)))
    _check(port.unembed(tp, torch.from_numpy(x)),
           ref.unembed(jp, jnp.asarray(x)))
