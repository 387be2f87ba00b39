"""Device meshes: the production meshes and a mesh over the local world.

Counterpart of the reference's ``launch/mesh.py``. Every mesh is built
by a FUNCTION, never a module constant, so importing this module touches
no process group.

Mesh shapes:
  single-pod: (16, 16)      axes (data, model)        — 256 devices
  multi-pod:  (2, 16, 16)   axes (pod, data, model)   — 512 devices

Axis semantics: ``data`` carries DP + FSDP (parameter/optimizer ZeRO-3
sharding); ``model`` carries TP/EP; ``pod`` is the outer data-parallel
replica axis (the gradient all-reduce crosses it once per step).

A process group of the mesh's size must be initialised first: the
dry-run uses a ``fake`` one of 256 or 512 ranks
(:mod:`repro_torch.launch.dryrun`); training uses gloo on the CPU or
NCCL on the card.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_ambient = threading.local()


def production_shape(multi_pod: bool):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """The (16, 16) or (2, 16, 16) mesh over an initialised world of 256
    or 512 ranks."""
    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_host_mesh(model: int = 1,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """(world // model, model) ``("data", "model")`` mesh over the
    initialised process group's world, on the card under NCCL and on the
    CPU otherwise."""
    n = dist.get_world_size()
    model = min(model, n)
    if n % model:
        raise ValueError(f"model parallelism {model} does not divide the "
                         f"world of {n} ranks")
    return init_device_mesh(device_type or _device_type(),
                            (n // model, model),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh):
    """Enter ``mesh`` as the ambient mesh (:func:`current_mesh`), the
    counterpart of the reference's ``jax.set_mesh``."""
    prev = getattr(_ambient, "mesh", None)
    _ambient.mesh = mesh
    try:
        yield mesh
    finally:
        _ambient.mesh = prev


def current_mesh() -> Optional[DeviceMesh]:
    return getattr(_ambient, "mesh", None)
