"""The port's sharding rules against the JAX package's: the reference's
spec tests, a property test that the port's spec equals the reference's
entry for entry, and the map from a spec to DTensor placements."""
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")
from jax.sharding import PartitionSpec as RefP
from torch.distributed.tensor import Replicate, Shard

from repro.distributed import sharding as ref_sharding
from repro_torch.configs import reduced_config
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (FSDP_RULES, SERVING_RULES,
                                              TP_RULES, P, PartitionSpec,
                                              Sharding, activation_sharding,
                                              constrain, placements)
from repro_torch.launch.mesh import describe
from repro_torch.models.model import Model
from repro_torch.training.optimizer import adamw_init, train_state_axes


class FakeMesh:
    """Duck-typed mesh: only .shape (name -> size, in mesh order) is
    consulted by the rules."""

    def __init__(self, **shape):
        self.shape = shape


#: every logical name of the base rules, and one no rule knows
NAMES = sorted(sharding._base_rules(True)) + ["unknown"]
MESHES = [dict(data=16, model=16), dict(pod=2, data=16, model=16),
          dict(data=4), dict(pod=2, data=2, model=4), dict(data=2, model=4),
          dict(model=8), dict(pod=4, data=1, model=1)]
DIMS = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 40, 48, 64, 96, 128, 256, 512,
        1000, 1024, 1536, 151_936]
#: the port's and the reference's rule tables, side by side, with the
#: overrides the reference's docs name (EP vs TP experts, SP activations)
RULES = [(FSDP_RULES, ref_sharding.FSDP_RULES),
         (TP_RULES, ref_sharding.TP_RULES),
         (SERVING_RULES, ref_sharding.SERVING_RULES),
         (FSDP_RULES.override(expert=None, mlp=("data", "model")),
          ref_sharding.FSDP_RULES.override(expert=None,
                                           mlp=("data", "model"))),
         (TP_RULES.override(act_seq="model", embed="data", vocab=None),
          ref_sharding.TP_RULES.override(act_seq="model", embed="data",
                                         vocab=None))]


def test_spec_divisibility_fallback():
    mesh = FakeMesh(data=16, model=16)
    # 40 experts don't divide 16 -> replicated; mlp dim shards
    spec = FSDP_RULES.spec(("expert", "embed", "mlp"), (40, 1536, 512),
                           mesh)
    assert spec == P(None, "data", "model")


def test_spec_never_reuses_mesh_axis():
    mesh = FakeMesh(data=16, model=16)
    spec = FSDP_RULES.spec(("mlp", "qkv"), (512, 512), mesh)
    parts = [p for p in spec if p is not None]
    flat = []
    for p in parts:
        flat.extend(p if isinstance(p, tuple) else [p])
    assert len(flat) == len(set(flat)), f"axis reused: {spec}"


def test_missing_mesh_axes_ignored():
    mesh = FakeMesh(data=4)               # no 'model', no 'pod'
    spec = FSDP_RULES.spec(("batch", "mlp"), (8, 512), mesh)
    assert spec == P("data")


@given(st.integers(1, 64), st.integers(1, 64),
       st.sampled_from([("batch", None), ("embed", "mlp"),
                        ("vocab", "embed"), ("expert", "embed", "mlp")]))
@settings(max_examples=80, deadline=None)
def test_spec_property_divides(d0, d1, axes):
    mesh = FakeMesh(pod=2, data=16, model=16)
    shape = tuple([d0, d1] + [128] * (len(axes) - 2))
    spec = FSDP_RULES.spec(axes, shape, mesh)
    # every sharded dim must be divisible by the product of its axes
    for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        if part is None:
            continue
        axes_t = part if isinstance(part, tuple) else (part,)
        prod = 1
        for a in axes_t:
            prod *= mesh.shape[a]
        assert dim % prod == 0


@st.composite
def logical_tensors(draw):
    ndim = draw(st.integers(0, 4))
    names = tuple(draw(st.sampled_from(NAMES + [None])) for _ in range(ndim))
    shape = tuple(draw(st.sampled_from(DIMS)) for _ in range(ndim))
    return names, shape


@given(logical_tensors(), logical_tensors(), logical_tensors())
@settings(max_examples=200, deadline=None)
def test_spec_equals_reference(t0, t1, t2):
    """Random shapes over every logical name, on meshes with and without
    ``pod``, under every rule table: the port's spec is the reference's
    PartitionSpec, entry for entry, trailing Nones dropped alike."""
    for names, shape in (t0, t1, t2):
        for rules, ref_rules in RULES:
            for shape_of in MESHES:
                mesh = FakeMesh(**shape_of)
                got = rules.spec(names, shape, mesh)
                want = ref_rules.spec(names, shape, mesh)
                assert isinstance(got, PartitionSpec)
                assert tuple(got) == tuple(want), (names, shape, shape_of)
                assert got == P(*want)


def test_every_name_on_the_production_meshes_matches_reference():
    for name in NAMES:
        for dim in DIMS:
            for shape_of in MESHES:
                for rules, ref_rules in RULES:
                    mesh = FakeMesh(**shape_of)
                    assert tuple(rules.spec((name, "embed"), (dim, 2048),
                                            mesh)) == \
                        tuple(ref_rules.spec((name, "embed"), (dim, 2048),
                                             mesh))


def test_partition_spec_is_the_reference_form():
    assert P() == () and P("data") == ("data",)
    assert tuple(P(None, ("pod", "data"), "model")) == \
        tuple(RefP(None, ("pod", "data"), "model"))
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


def test_placements_one_per_mesh_dim():
    mesh = FakeMesh(pod=2, data=16, model=16)
    assert placements(P(), mesh) == (Replicate(),) * 3
    assert placements(P(None, "model"), mesh) == \
        (Replicate(), Replicate(), Shard(1))
    # a dim over ("pod", "data") is sharded on both mesh dims
    assert placements(P(("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert placements(P("data", None, "model"), FakeMesh(data=4, model=2)) \
        == (Shard(0), Shard(2))
    sh = FSDP_RULES.sharding(("vocab", "embed"), (512, 64),
                             FakeMesh(data=2, model=4))
    assert isinstance(sh, Sharding)
    assert sh.placements == (Shard(1), Shard(0))


def test_placements_replicate_over_mesh_dims_of_one_device():
    mesh = FakeMesh(pod=1, data=1, model=4)
    assert placements(P(("pod", "data"), "model"), mesh) == \
        (Replicate(), Replicate(), Shard(1))
    sh = FSDP_RULES.sharding(("batch", "act_seq", "vocab"), (8, 512, 1024),
                             FakeMesh(data=1, model=1))
    assert sh.placements == (Replicate(), Replicate())
    # the spec keeps the reference's entries all the same
    assert FSDP_RULES.spec(("batch", "act_seq", "vocab"), (8, 512, 1024),
                           FakeMesh(data=1, model=1)) == \
        P("data", None, "model")


def test_placements_refuse_out_of_mesh_order_and_unknown_axes():
    mesh = FakeMesh(pod=2, data=16, model=16)
    with pytest.raises(ValueError, match="mesh order"):
        placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        placements(P("expert"), mesh)
    rules = FSDP_RULES.override(batch=("model", "data"))
    with pytest.raises(ValueError, match="mesh order"):
        rules.sharding(("batch",), (256,), mesh)


def test_tree_shardings_over_a_train_state():
    model = Model(reduced_config("qwen3-0.6b"), device="cpu")
    specs, axes = model.abstract_params()
    state, st_axes = adamw_init(specs), train_state_axes(axes)
    mesh = FakeMesh(data=2, model=4)
    sh = sharding.tree_shardings(mesh, FSDP_RULES, st_axes, state)
    # embed (vocab over model, d over data), the stacked wq (layers
    # unsharded), the step counter replicated
    assert sh["params"]["embed"]["tok"].placements == (Shard(1), Shard(0))
    assert sh["m"]["layers"]["attn"]["wq"].placements == (Shard(1), Shard(2))
    assert sh["step"] == Sharding(mesh, (Replicate(), Replicate()))
    assert sharding.logical_to_sharding(st_axes, state, mesh,
                                        FSDP_RULES) == sh
    assert sharding.shard_batch_spec(mesh, FSDP_RULES, 8, 2).placements == \
        (Shard(0), Replicate())
    assert sharding.shard_batch_spec(mesh, FSDP_RULES, 3, 2).placements == \
        (Replicate(), Replicate())


def test_constrain_is_a_no_op_on_plain_tensors():
    x = torch.ones(4, 8)
    assert constrain(x, ("batch", None)) is x
    with activation_sharding(FakeMesh(data=2), FSDP_RULES):
        assert constrain(x, ("batch", None)) is x
    assert sharding._ACT_CTX.value is None


def test_describe_mesh():
    assert describe(FakeMesh(pod=2, data=16, model=16)) == \
        "pod=2 x data=16 x model=16"
