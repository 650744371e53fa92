"""The training mesh on ``torch.distributed`` (the port of
``repro/launch/mesh.py::make_host_mesh``).

One process per rank.  Nothing on a GPU machine tells a program of a
cluster: the process group comes from ``torch.distributed.run``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``,
``LOCAL_RANK``) unless the caller has initialised it already (tests do,
with a ``file://`` store).  Gloo serves ``"cpu"``, NCCL ``"cuda"``.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.sharding import DATA_AXIS, MDOM_AXIS, MTP_AXIS, Mesh


def make_host_mesh(model: int = 4, *, device="cuda") -> Mesh:
    """This rank's place on a (data=1, mdom=q, mtp=q) mesh with q*q = model
    (the reference's ``make_host_mesh(two_d=True)``; a data axis is
    ``TrainEngine``'s to refuse until it is ported).

    A 1x1 mesh needs no process group.  Otherwise the default process
    group is initialised (``env://``) if it is not yet, its world must hold
    ``model`` ranks, and on CUDA the rank's device is ``cuda:LOCAL_RANK``,
    set as the current device before any communicator is made."""
    q = math.isqrt(model)
    if q * q != model:
        raise ValueError(f"2-D Jigsaw needs a square model mesh; got "
                         f"{model} ranks")
    if model == 1:
        return Mesh()
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if device.type == "cuda" else "gloo")
    world = dist.get_world_size()
    if world != model:
        raise ValueError(f"a {q}x{q} mesh needs {model} ranks; the process "
                         f"group has {world}")
    dm = init_device_mesh(device.type, (1, q, q),
                          mesh_dim_names=(DATA_AXIS, MDOM_AXIS, MTP_AXIS))
    _, i, j = dm.get_coordinate()
    dom, tp = dm.get_group(MDOM_AXIS), dm.get_group(MTP_AXIS)
    if dist.get_rank(dom) != i or dist.get_rank(tp) != j:
        raise RuntimeError("mesh groups are not ordered by coordinate")
    return Mesh(q=q, i=i, j=j, dom_group=dom, tp_group=tp,
                model_group=dist.group.WORLD)
