"""The port's configs equal the reference registry's, field by field."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import registry as ref_registry
from repro_torch.configs import ARCH_IDS, get_config, reduced_config

#: the port's name for each reference attention impl it ports
_IMPL = {"xla": "plain", "pallas": "kernel"}


def _assert_same(port, ref):
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "attn_impl":
            want = _IMPL[want]
        if f.name in ("ssm", "moe") and want is not None:  # own classes
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert port.hd == ref.hd
    assert port.padded_vocab == ref.padded_vocab
    assert port.block_cfg().head_dim == ref.block_cfg().head_dim


def test_port_registry_is_the_dense_family():
    """The registry holds the ported families, dense, moe and hybrid; an
    arch of another family raises."""
    assert sorted(ARCH_IDS) == sorted(
        a for a in ref_registry.ARCH_IDS
        if ref_registry.get_config(a).family in ("dense", "moe", "hybrid"))
    assert get_config("zamba2-1.2b").family == "hybrid"
    assert get_config("qwen2-moe-a2.7b").family == "moe"
    with pytest.raises(KeyError, match="not ported"):
        get_config("xlstm-350m")


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
