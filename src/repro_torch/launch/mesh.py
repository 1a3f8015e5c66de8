"""Production meshes (counterpart of ``repro.launch.mesh``).

Single pod: (16, 16) = 256 devices, axes ("data", "model"):
data-parallel x model-parallel.
Multi-pod: (2, 16, 16) = 512 devices, axes ("pod", "data", "model"):
the ``pod`` axis is the outer data-parallel dim whose collectives cross
the inter-pod links (where the int8 gradient compression applies).

Each mesh is a torch ``DeviceMesh`` over the default process group,
whose world size must equal the mesh's size; the caller starts that
group (``torch.distributed.init_process_group``). Functions, not module
constants: importing this module touches no process group.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed.sharding import mesh_axes


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device_type: str = "cuda") -> DeviceMesh:
    """Small mesh for tests (a world of ``prod(shape)`` ranks)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def describe(mesh) -> str:
    return " x ".join(f"{k}={v}" for k, v in mesh_axes(mesh).items())
