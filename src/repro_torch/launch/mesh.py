"""Production mesh construction (the counterpart of ``repro.launch.mesh``).

Functions, not module-level constants, so that importing this module
touches no process group. Both meshes are built with ``init_device_mesh``
over the default process group: a real one on the card, or the ``fake``
world of :func:`start_fake_world`, the counterpart of the reference dry
run's ``XLA_FLAGS=--xla_force_host_platform_device_count=512``: one
process stands for every rank of a world of placeholder devices, every
collective is a no-op, and tensors under ``FakeTensorMode`` carry shapes
without storage. Like those flags it is process-global, so the dry run and
the profile run as processes of their own.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def start_fake_world(world_size: int) -> None:
    """Start a ``fake`` default process group of ``world_size`` ranks in
    this process, as rank 0; raise if another group is running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        raise RuntimeError("a process group is already running: the fake "
                           "world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


# the device type of a mesh over each backend's default process group
BACKEND_DEVICE = {"fake": "cpu", "gloo": "cpu", "nccl": "cuda"}


def mesh_of(shape: Tuple[int, ...], names: Tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` over the default process group, on the device its
    backend runs on (:data:`BACKEND_DEVICE`)."""
    backend = dist.get_backend()
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"no mesh over a {backend!r} process group "
                         f"(have {sorted(BACKEND_DEVICE)})")
    return init_device_mesh(BACKEND_DEVICE[backend], shape, mesh_dim_names=names)


@functools.lru_cache(maxsize=None)
def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 single pod (256 devices) or 2x16x16 multi-pod (512).

    Axes: ("data", "model") single-pod; ("pod", "data", "model") multi-pod.
    "model" is the fast plane (per-layer TP collectives); "pod" the slow
    one (gradient reduction only). The default process group must have
    that many ranks. One mesh a layout for the process.
    """
    return mesh_of(*PRODUCTION_SHAPES[multi_pod])


def make_dev_mesh(n_data: int = 2, n_model: int = 4, *,
                  multi_pod: bool = False) -> DeviceMesh:
    """Small mesh for integration tests."""
    if multi_pod:
        return mesh_of((2, n_data, n_model), ("pod", "data", "model"))
    return mesh_of((n_data, n_model), ("data", "model"))
