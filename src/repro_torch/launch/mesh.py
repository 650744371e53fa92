"""The training meshes on ``torch.distributed`` (the port of
``repro/launch/mesh.py::make_host_mesh``).

One process per rank.  Nothing on a GPU machine tells a program of a
cluster: the process group comes from ``torch.distributed.run``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``,
``LOCAL_RANK``) unless the caller has initialised it already (tests do,
with a ``file://`` store).  Gloo serves ``"cpu"``; on CUDA, NCCL serves
ranks on distinct cards and gloo ranks that share one
(``make_ring_mesh``).
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.sharding import (DATA_AXIS, MDOM_AXIS, MTP_AXIS, Mesh,
                                      Mesh1D)


def make_ring_mesh(model: int = 4, *, device="cuda") -> Mesh1D:
    """This rank's place on a (data=1, model=p) mesh with p = ``model``
    ranks and one tp group, the world (the reference's
    ``make_host_mesh(two_d=False)``; a data axis is ``TrainEngine``'s to
    refuse until it is ported).

    On CUDA, rank r runs on ``cuda:(LOCAL_RANK % device_count)``, so p
    ranks fit on fewer cards, down to one: that is how p ranks of the 1-D
    ring run on one H100, as the reference's host-emulated devices run p
    devices on one host.  Ranks that share a card take a gloo group (NCCL
    refuses two ranks on one device; ``core/comm.py`` then copies through
    the host what gloo cannot take on the device), ranks on distinct cards
    NCCL.  The ring kernels reach the successor's slots by CUDA IPC either
    way.  A one-rank mesh needs no process group."""
    if model == 1:
        return Mesh1D()
    device = torch.device(device)
    backend = "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % cards)
        backend = "nccl" if model <= cards else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend=backend)
    world = dist.get_world_size()
    if world != model:
        raise ValueError(f"a 1-D mesh of {model} ranks needs {model} "
                         f"processes; the process group has {world}")
    if device.type == "cuda" and backend == "gloo" \
            and dist.get_backend() == "nccl":
        raise ValueError(f"{model} ranks share {cards} card(s): NCCL "
                         "refuses two ranks on one device; initialise the "
                         "process group with gloo")
    return Mesh1D(p=model, r=dist.get_rank(), tp_group=dist.group.WORLD)


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
