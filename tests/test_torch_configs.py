"""The port's configs equal the reference registry's, field by field."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import registry as ref_registry
from repro_torch.configs import ARCH_IDS, get_config, reduced_config

#: the port's name for each reference attention impl it ports
_IMPL = {"xla": "plain", "pallas": "kernel"}


def _port_only(port, ref) -> dict:
    """The fields of the port's config ``port`` that the reference's
    ``ref`` lacks (options of the port alone, such as Granite's scalars),
    with their defaults: a reference arch keeps every one at it."""
    return {f.name: f.default for f in dataclasses.fields(port)
            if not hasattr(ref, f.name)}


def _assert_same(port, ref):
    for f in dataclasses.fields(port):
        if not hasattr(ref, f.name):
            assert getattr(port, f.name) == f.default, f.name
            continue
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "attn_impl":
            want = _IMPL[want]
        if f.name in ("ssm", "moe", "xlstm") and want is not None:
            # the port's own classes
            for name, default in _port_only(got, want).items():
                assert getattr(got, name) == default, f"{f.name}.{name}"
            got = {k: v for k, v in dataclasses.asdict(got).items()
                   if hasattr(want, k)}
            want = dataclasses.asdict(want)
        assert got == want, f.name
    assert port.hd == ref.hd
    assert port.padded_vocab == ref.padded_vocab
    assert port.block_cfg().head_dim == ref.block_cfg().head_dim


def test_port_registry_is_the_dense_family():
    """The registry holds every arch of the reference's registry (ten),
    in all six of its families (the name dates from the first slice, which held the dense
    family alone); an unknown arch raises."""
    assert ARCH_IDS == list(ref_registry.ARCH_IDS)
    assert len(ARCH_IDS) == 10
    assert {get_config(a).family for a in ARCH_IDS} == {
        "dense", "moe", "hybrid", "ssm", "audio", "vlm"}
    assert get_config("xlstm-350m").family == "ssm"
    assert get_config("whisper-tiny").family == "audio"
    assert get_config("llama-3.2-vision-90b").family == "vlm"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("not-an-arch")


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(arch, reduced):
    if reduced:
        _assert_same(reduced_config(arch), ref_registry.reduced_config(arch))
    else:
        _assert_same(get_config(arch), ref_registry.get_config(arch))


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_n_params_matches_reference(arch):
    assert get_config(arch).n_params() == \
        ref_registry.get_config(arch).n_params()
    assert reduced_config(arch).n_params() == \
        ref_registry.reduced_config(arch).n_params()
