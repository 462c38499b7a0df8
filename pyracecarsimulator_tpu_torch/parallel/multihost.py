"""Multi-host orchestration on ``torch.distributed``.

Counterpart of ``pyracecarsimulator_tpu/parallel/multihost.py``: one
process per device joins one process group, and ``make_pod_mesh`` lays the
ranks out so that the ``agents`` axis spans hosts while the ``beams`` axis
stays inside a host: the scan's collectives (the TTC all-reduce, the
gradient all-reduce) then ride the intra-host links, and agent slabs
cross hosts only at checkpoint and metric boundaries.

The process group is configured by what ``torchrun`` sets: ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE``. The
backend is the caller's choice and is never switched: ``"nccl"`` where
each rank owns a card, ``"gloo"`` on the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch.distributed as dist

from .mesh import Mesh, make_mesh, mesh_shape


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               timeout_s: Optional[float] = None) -> None:
    """``dist.init_process_group`` wrapper, idempotent. ``backend`` is
    handed on as it is (``None`` is PyTorch's own default: gloo for CPU
    tensors and NCCL for CUDA tensors). With ``init_method``, ``world_size``
    and ``rank`` left ``None`` the group is read from the environment
    (``env://``), as ``torchrun`` sets it; where that is missing too, this
    raises and names the variables."""
    if dist.is_initialized():
        return
    if init_method is None and not all(
            k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT")):
        raise RuntimeError(
            "no rendezvous: pass init_method (for example "
            "'tcp://localhost:29500') with world_size and rank, or run "
            "under torchrun, which sets MASTER_ADDR, MASTER_PORT, RANK and "
            "WORLD_SIZE")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend=backend, init_method=init_method, **kw)


def pod_mesh_shape(beams_axis: int = 1) -> Tuple[int, int]:
    """(agents, beams) of the pod mesh: ``beams`` is carved from the ranks
    of one host first, so it must divide ``LOCAL_WORLD_SIZE`` (where that
    is not set, the world size: one host). The world size is the process
    group's or, before it is initialised, ``WORLD_SIZE``."""
    world_size = (dist.get_world_size() if dist.is_initialized()
                  else int(os.environ["WORLD_SIZE"]))
    local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if beams_axis > local_world_size or local_world_size % beams_axis:
        raise ValueError(
            f"beams_axis={beams_axis} must divide the host's ranks "
            f"{local_world_size} (keeps beam collectives inside a host)")
    return mesh_shape(world_size, None, beams_axis)


def make_pod_mesh(beams_axis: int = 1) -> Mesh:
    """Global mesh over every rank of the job. ``torchrun`` numbers a
    host's ranks contiguously and the mesh is row-major (``rank =
    agents_index * beams + beams_index``), so with ``beams_axis`` dividing
    the host's rank count every ``beams`` group lies inside one host."""
    agents_axis, beams_axis = pod_mesh_shape(beams_axis)
    return make_mesh(agents_axis, beams_axis)


def global_agent_count(per_device_agents: int, mesh: Mesh) -> int:
    return per_device_agents * mesh.agents
