"""Device meshes over the running ``torch.distributed`` process group: the
port of ``repro.launch.mesh``.

Functions, not module constants, so importing this module touches no
device and no process group.  Each builds a ``DeviceMesh`` with named axes
(``init_device_mesh``) over a process group the caller has already started
with ``torch.distributed.init_process_group`` (its address, world size and
rank given explicitly; NCCL on CUDA, gloo on the CPU); without one they
raise.  Single pod: 16 x 16 = 256 ranks; multi-pod adds a leading ``pod``
axis, 2 x 16 x 16 = 512.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist

from repro_torch.kernels.kron_matvec._layout import resolve_device
from repro_torch.models.sharding import require_group


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    """A mesh of ``shape`` named ``axes`` over the running process group,
    whose world size must equal the product of ``shape``.  ``device``:
    ``cuda`` unless told otherwise (each rank on its own card)."""
    from torch.distributed.device_mesh import init_device_mesh
    require_group()
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= int(s)
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device=None, shape: Optional[Sequence[int]] = None):
    """Every rank of the running process group as a 1 x N (data, model)
    mesh (or ``shape``, a (data, model) pair): what examples and smoke
    tests run on."""
    require_group()
    shape = tuple(shape) if shape is not None else (1, dist.get_world_size())
    return make_mesh(shape, ("data", "model"), device)
