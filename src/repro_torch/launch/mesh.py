"""The training meshes on ``torch.distributed`` (the port of
``repro/launch/mesh.py::make_host_mesh``).

One process per rank.  Nothing on a GPU machine tells a program of a
cluster: the process group comes from ``torch.distributed.run``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``,
``LOCAL_RANK``) unless the caller has initialised it already (tests do,
with a ``file://`` store).  Gloo serves ``"cpu"``; on CUDA, NCCL serves
ranks on distinct cards and gloo ranks that share one (``_join``), under
both meshes.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.core.sharding import (DATA_AXIS, MDOM_AXIS, MTP_AXIS, Mesh,
                                      Mesh1D)


def _join(model: int, device: torch.device, what: str) -> None:
    """Put this rank on its card and join the default process group of
    ``model`` ranks (``env://`` unless the caller has joined one).

    On CUDA, rank r runs on ``cuda:(LOCAL_RANK % device_count)``, so the
    ranks fit on fewer cards, down to one: that is how the ranks of either
    mesh run on one H100, as the reference's host-emulated devices run on
    one host.  Ranks that share a card take gloo (NCCL refuses two ranks
    on one device; ``core/comm.py`` then copies through the host what gloo
    cannot take on the device), ranks on distinct cards NCCL.  The ring
    and Cannon kernels reach their peers' slots by CUDA IPC either way."""
    backend = "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % cards)
        backend = "nccl" if model <= cards else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend=backend)
    world = dist.get_world_size()
    if world != model:
        raise ValueError(f"{what} needs {model} processes; the process "
                         f"group has {world}")
    if device.type == "cuda" and backend == "gloo" \
            and dist.get_backend() == "nccl":
        raise ValueError(f"{model} ranks share {cards} card(s): NCCL "
                         "refuses two ranks on one device; initialise the "
                         "process group with gloo")


def make_ring_mesh(model: int = 4, *, device="cuda") -> Mesh1D:
    """This rank's place on a (data=1, model=p) mesh with p = ``model``
    ranks and one tp group, the world (the reference's
    ``make_host_mesh(two_d=False)``; a data axis is ``TrainEngine``'s to
    refuse until it is ported).  The process group and the card as
    ``_join`` sets them; a one-rank mesh needs no process group."""
    if model == 1:
        return Mesh1D()
    _join(model, torch.device(device), f"a 1-D mesh of {model} ranks")
    return Mesh1D(p=model, r=dist.get_rank(), tp_group=dist.group.WORLD)


def make_host_mesh(model: int = 4, *, device="cuda") -> Mesh:
    """This rank's place on a (data=1, mdom=q, mtp=q) mesh with q*q = model
    (the reference's ``make_host_mesh(two_d=True)``; a data axis is
    ``TrainEngine``'s to refuse until it is ported).

    A 1x1 mesh needs no process group.  Otherwise the process group and
    the card as ``_join`` sets them (four ranks of a 2x2 mesh can share
    one card, under gloo); rank r = i * q + j sits at mdom coordinate i and
    mtp coordinate j, and its mdom group (the q ranks of column j) and mtp
    group (row i) are made with ``dist.new_group``, every rank making every
    group in the same order."""
    q = math.isqrt(model)
    if q * q != model:
        raise ValueError(f"2-D Jigsaw needs a square model mesh; got "
                         f"{model} ranks")
    if model == 1:
        return Mesh()
    _join(model, torch.device(device), f"a {q}x{q} mesh")
    i, j = divmod(dist.get_rank(), q)
    doms = [dist.new_group([a * q + b for a in range(q)]) for b in range(q)]
    tps = [dist.new_group([a * q + b for b in range(q)]) for a in range(q)]
    dom, tp = doms[j], tps[i]
    if dist.get_rank(dom) != i or dist.get_rank(tp) != j:
        raise RuntimeError("mesh groups are not ordered by coordinate")
    return Mesh(q=q, i=i, j=j, dom_group=dom, tp_group=tp,
                model_group=dist.group.WORLD)
