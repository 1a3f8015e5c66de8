"""The port's logical axes against the JAX package's: every param maker's
axes tree (through ``Model.param_axes``), the meta-device abstract
params, the cache axes, the train-state and batch axes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from repro.configs import registry as ref_registry
from repro.configs.shapes import Shape as RefShape
from repro.models import transformer as ref_transformer
from repro.models.model import Model as RefModel
from repro.training import data as ref_data
from repro.training import optimizer as ref_opt
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs.shapes import Shape
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.training import data
from repro_torch.training.optimizer import train_state_axes


def _walk(t):
    """The port's leaves in sorted-key order, as ``jax.tree.leaves``
    walks."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _walk(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _walk(v)]
    return [t]


def _same_shapes(port_tree, ref_tree):
    """Every meta leaf of the port has the shape and dtype of the
    reference's ShapeDtypeStruct at the same place."""
    port = _walk(port_tree)
    ref = jax.tree.leaves(ref_tree)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p.device.type == "meta"
        assert tuple(p.shape) == tuple(r.shape)
        assert str(p.dtype).removeprefix("torch.") == np.dtype(r.dtype).name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_match_reference_reduced(arch):
    _, ref_axes = RefModel(ref_registry.reduced_config(arch)).build(
        jax.random.key(0))
    model = Model(reduced_config(arch), device="cpu")
    assert model.param_axes() == ref_axes
    params, axes = model.build(seed=0)
    assert axes == ref_axes
    # the axes tree names every param leaf, one name per dim
    flat_axes = jax.tree.leaves(axes, is_leaf=transformer.is_axes_leaf)
    leaves = _walk(params)
    assert [len(a) for a in flat_axes] == [p.dim() for p in leaves]
    assert all(p.device.type == "cpu" for p in leaves)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_reference_full(arch):
    ref_specs, ref_axes = RefModel(ref_registry.get_config(arch)) \
        .abstract_params()
    specs, axes = Model(get_config(arch), device="meta").abstract_params()
    assert axes == ref_axes
    _same_shapes(specs, ref_specs)
    # the leaves line up with their axes, one logical name per dim
    flat_axes = jax.tree.leaves(ref_axes, is_leaf=ref_transformer.is_axes_leaf)
    assert [len(a) for a in flat_axes] == [len(s.shape) for s in
                                           jax.tree.leaves(ref_specs)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_reduced_from_any_device(arch):
    """abstract_params draws nothing and allocates nothing, whatever the
    model's device."""
    ref_specs, _ = RefModel(ref_registry.reduced_config(arch)) \
        .abstract_params()
    specs, _ = Model(reduced_config(arch), device="cpu").abstract_params()
    _same_shapes(specs, ref_specs)


#: every arch with its bf16 cache, and the dense and MoE archs, whose
#: decode also has the int8 KV cache, with that
CACHES = [(a, False) for a in ARCH_IDS] + [
    (a, True) for a in ARCH_IDS if get_config(a).family in ("dense", "moe")]


@pytest.mark.parametrize("arch,quant", CACHES)
def test_cache_axes_match_abstract_cache(arch, quant):
    ref_cfg = ref_registry.get_config(arch, kv_cache_quant=quant)
    ref_specs, ref_axes = RefModel(ref_cfg).abstract_cache(2, 256)
    cache, axes = Model(get_config(arch, kv_cache_quant=quant),
                        device="meta").make_cache(2, 256)
    assert axes == ref_axes
    _same_shapes(cache, ref_specs)


def test_train_state_axes_match_reference():
    cfg = reduced_config("qwen2-moe-a2.7b")
    axes = Model(cfg, device="cpu").param_axes()
    assert train_state_axes(axes) == ref_opt.train_state_axes(axes)
    assert train_state_axes(axes)["step"] == ()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-tiny",
                                  "llama-3.2-vision-90b"])
def test_batch_specs_and_axes_match_reference(arch, kind):
    shape = Shape("t", 64, 4, kind)
    specs = data.batch_specs(get_config(arch), shape, kind=kind)
    ref = ref_data.batch_specs(ref_registry.get_config(arch),
                               RefShape("t", 64, 4, kind), kind=kind)
    assert list(specs) == list(ref)
    for k, t in specs.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[k].shape)
        want = np.dtype(ref[k].dtype).name
        # tokens are int64 in the port, where the reference's are int32
        want = "int64" if want == "int32" else want
        assert str(t.dtype).removeprefix("torch.") == want
    assert data.batch_axes_for(specs) == ref_data.batch_axes_for(ref)
    assert data.BATCH_AXES == ref_data.BATCH_AXES


def test_is_axes_leaf_and_prepend_axis_match_reference():
    cases = [("embed", "mlp"), (), (None, "embed"), ("a", 1), ["embed"],
             {"w": ("embed",)}, "embed"]
    for c in cases:
        assert transformer.is_axes_leaf(c) == ref_transformer.is_axes_leaf(c)
    tree = {"attn": {"wq": ("embed", "qkv"), "g": ()},
            "layers": [{"n": ("embed",)}, {"n": (None,)}]}
    for name in ("layers", "seg"):
        assert transformer.prepend_axis(tree, name) == \
            ref_transformer.prepend_axis(tree, name)
    assert transformer.prepend_axis(tree) == \
        ref_transformer.prepend_axis(tree)
