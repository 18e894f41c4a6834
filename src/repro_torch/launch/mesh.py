"""Device meshes of the port (torch counterpart of ``repro.launch.mesh`` and
of ``repro.runtime.elastic.make_mesh_for``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, with the reference's axis names: ``("data",
"model")`` or ``("pod", "data", "model")``, laid out row-major (global rank
= ``(pod * data + d) * model + m``), as ``jax.make_mesh`` lays out devices.
``MeshShape`` carries the same names and sizes with no devices behind them,
as the reference's ``AbstractMesh`` does: the sharding rules and the dry
run's arithmetic take either.

Functions, not module-level meshes: building one needs a process group,
and importing this module must not start one.

The roofline constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet
(dense rates, no sparsity), at the full 700 W power limit; a card set below
it (``nvidia-smi --query-gpu=name,power.limit``) runs slower under load, so
every number read against them is printed beside the card's name and power
limit.
"""
from __future__ import annotations

import dataclasses
import math

PEAK_FLOPS_BF16 = 989e12   # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12           # B/s, HBM3
NVLINK_BW = 450e9          # B/s per direction (900 GB/s both ways, 18 NVLink 4 links)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without devices."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_shape(mesh) -> MeshShape:
    """The ``MeshShape`` of a ``DeviceMesh`` (or of a ``MeshShape``)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def production_shape(multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def device_mesh(shape: MeshShape, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over the default process group, whose
    world size must be ``shape.size``. ``device_type`` None: ``cuda`` under
    NCCL, else ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a device mesh needs an initialised default process group")
    if dist.get_world_size() != shape.size:
        raise ValueError(f"a {dict(shape.shape)} mesh needs {shape.size} ranks, the "
                         f"default group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape.sizes, mesh_dim_names=shape.axis_names)


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh: ``("data", "model")`` = (16, 16), or
    ``("pod", "data", "model")`` = (2, 16, 16)."""
    return device_mesh(production_shape(multi_pod), device_type)


def mesh_shape_for(world: int, model_parallel: int = 1, pods: int = 1,
                   data_only: bool = False) -> MeshShape:
    """The layout ``make_mesh_for`` gives ``world`` ranks (the reference's
    ``runtime/elastic.py::make_mesh_for``, same checks and messages)."""
    if model_parallel * pods <= 0 or world % (model_parallel * pods) != 0:
        raise ValueError(
            f"cannot lay {world} devices out as pods={pods} x data x "
            f"model_parallel={model_parallel}: {world} % {model_parallel * pods} != 0")
    if data_only:
        if model_parallel != 1 or pods != 1:
            raise ValueError("data_only mesh cannot carry model/pod axes")
        return MeshShape(("data",), (world,))
    data = world // (model_parallel * pods)
    if pods > 1:
        return MeshShape(("pod", "data", "model"), (pods, data, model_parallel))
    return MeshShape(("data", "model"), (data, model_parallel))


def make_mesh_for(world: int, model_parallel: int = 1, pods: int = 1,
                  data_only: bool = False, device_type: str | None = None):
    """A ``DeviceMesh`` over the ``world`` ranks of the default group:
    ``("pod", "data", "model")`` with ``pods`` > 1, else ``("data",
    "model")``, or ``("data",)`` alone with ``data_only``."""
    return device_mesh(mesh_shape_for(world, model_parallel, pods, data_only), device_type)
