"""Device meshes of the sharded LM, ported from the reference's
``launch/mesh.py``: ``torch.distributed``'s :class:`DeviceMesh` over named
dims, built on a default process group that the caller starts.

  single-pod : (data=16, model=16)          dims ("data", "model")
  multi-pod  : (pod=2, data=16, model=16)   dims ("pod", "data", "model")

The production meshes hold 256 and 512 ranks; a run builds them only under
the dry run's fake process group (:mod:`.dryrun`). The test meshes are
(2, 2) and (2, 2, 2).

The reference's ``use_mesh`` and ``shard_map_compat`` have no counterpart:
the port's sharded code is written per rank already (DTensor placements,
``to_local`` / ``from_local`` and collectives on ``mesh.get_group(name)``),
so there is no ambient mesh to install and no ``shard_map`` to wrap.

:func:`init_group` starts the default group on a ``FileStore`` (or the
fake group's ``FakeStore``), so that no rank opens a network port.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..kernels.ops import resolve_device

__all__ = ["DeviceMesh", "make_mesh", "make_production_mesh",
           "make_test_mesh", "batch_axes", "init_group"]


def _device_type(device_type: Optional[str]) -> str:
    return resolve_device(device_type).type


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None) -> DeviceMesh:
    """``init_device_mesh`` over the default group (whose world size must
    be the mesh's size) with ``axes`` as the dim names; ``device_type``
    defaults to ``cuda`` and raises without a card (``ops.resolve_device``):
    a mesh on the CPU takes ``device_type="cpu"``."""
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_test_mesh(*, multi_pod: bool = False,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """The tiny mesh of the tests: (2, 2), or (2, 2, 2) multi-pod."""
    shape = (2, 2, 2) if multi_pod else (2, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def batch_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The mesh dims the batch is split over: ``pod`` and ``data``."""
    return tuple(n for n in mesh.mesh_dim_names if n in ("pod", "data"))


def init_group(backend: str, rank: int, world: int,
               store_dir: Optional[str] = None) -> None:
    """Start the default process group: ``backend`` ``"gloo"`` or
    ``"nccl"`` on a ``FileStore`` under ``store_dir`` (every rank gives the
    same directory; the file must not be left from an earlier group), or
    ``"fake"`` on a ``FakeStore`` (the dry run's group: one process plays
    ``rank`` of ``world``, and every collective returns at once)."""
    if backend == "fake":
        # importing it registers the "fake" backend with torch.distributed
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    else:
        if store_dir is None:
            raise ValueError(f"backend {backend!r} needs a store_dir")
        store = dist.FileStore(os.path.join(store_dir, "group_store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
