"""The rows mesh of a row-partitioned solve, on ``torch.distributed``.

The counterpart of :mod:`krylov_tpu.dist.mesh`.  The JAX package is one
controller over a ``Mesh`` of devices; a PyTorch program is one process a
rank, so the mesh here is a one-dimensional
:class:`~torch.distributed.device_mesh.DeviceMesh` over the world that the
caller has initialised, one device a rank, with the rows axis as its one
dimension.  NCCL serves it on cards, gloo on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from krylov_tpu_torch.device import default_device

ROW_AXIS = "rows"


def row_axis() -> str:
    return ROW_AXIS


def make_mesh(device_type: Optional[str] = None, axis: str = ROW_AXIS):
    """1-D :class:`~torch.distributed.device_mesh.DeviceMesh` over every rank
    of the initialised world, its dimension named ``axis``.

    ``device_type`` defaults to the type of the port's default device
    (``cuda`` unless :func:`krylov_tpu_torch.set_default_device` chose
    another), so nothing falls back to the CPU.  The caller initialises the
    process group first (``torch.distributed.init_process_group``, NCCL for
    ``cuda``, gloo for ``cpu``), as a ``torch.distributed`` program does,
    and on a card sets its device (``torch.cuda.set_device``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group (nccl on cards, gloo on the CPU) first"
        )
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or default_device().type
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))
