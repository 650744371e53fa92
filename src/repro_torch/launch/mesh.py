"""The training meshes on ``torch.distributed`` (the port of
``repro/launch/mesh.py::make_host_mesh``).

One process per rank.  Nothing on a GPU machine tells a program of a
cluster: the process group comes from ``torch.distributed.run``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``,
``LOCAL_RANK``) unless the caller has initialised it already (tests do,
with a ``file://`` store).  Gloo serves ``"cpu"``; on CUDA, NCCL serves
ranks on distinct cards and gloo ranks that share one (``_join``), under
both meshes.

A mesh of ``data`` x ``model`` ranks numbers them with data outermost, as
the reference's axis order ``(data, model)`` / ``(data, mdom, mtp)``: rank
= d * p + r under 1-D, d * q * q + i * q + j under 2-D.  Each data index
has its own model group (its Jigsaw group: the ring's, the Cannon's and
the LayerNorms' collectives), each model coordinate its data group (the
gradients' sum, ZeRO-1's gathers, the FSDP hybrid's weight gathers).
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.core.sharding import Mesh, Mesh1D


def _join(ranks: int, device: torch.device, what: str) -> None:
    """Put this rank on its card and join the default process group of
    ``ranks`` ranks (``env://`` unless the caller has joined one).

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
        backend = "nccl" if ranks <= cards else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend=backend)
    world = dist.get_world_size()
    if world != ranks:
        raise ValueError(f"{what} needs {ranks} processes; the process "
                         f"group has {world}")
    if device.type == "cuda" and backend == "gloo" \
            and dist.get_backend() == "nccl":
        raise ValueError(f"{ranks} ranks share {cards} card(s): NCCL "
                         "refuses two ranks on one device; initialise the "
                         "process group with gloo")


def _groups(model: int, data: int):
    """(this rank's data index, its index in the model group, its model
    group, its data group): one model group per data index, one data group
    per model index, every rank making every group in the same order (as
    ``dist.new_group`` requires); None where a group would hold one rank.
    The model group of a one-data mesh is the world, and so is the data
    group of a one-rank model group."""
    d, m = divmod(dist.get_rank(), model)
    model_group = data_group = None
    if model > 1:
        model_group = dist.group.WORLD if data == 1 else [
            dist.new_group(list(range(e * model, (e + 1) * model)))
            for e in range(data)][d]
    if data > 1:
        data_group = dist.group.WORLD if model == 1 else [
            dist.new_group(list(range(k, data * model, model)))
            for k in range(model)][m]
    return d, m, model_group, data_group


def _data_fields(data: int, d: int, data_group, model: int) -> dict:
    return dict(data_size=data, data_index=d, data_group=data_group,
                world_group=dist.group.WORLD if model > 1 and data > 1
                else None)


def make_ring_mesh(model: int = 4, data: int = 1, *,
                   device="cuda") -> Mesh1D:
    """This rank's place on a (data, model=p) mesh of ``data`` x ``model``
    ranks (the reference's ``make_host_mesh(two_d=False)``): rank = d * p
    + r.  The process group and the card as ``_join`` sets them; a
    one-rank mesh needs no process group."""
    if model * data == 1:
        return Mesh1D()
    _join(model * data, torch.device(device),
          f"a (data {data}, model {model}) mesh")
    d, r, tp, dg = _groups(model, data)
    return Mesh1D(p=model, r=r, tp_group=tp,
                  **_data_fields(data, d, dg, model))


def make_host_mesh(model: int = 4, data: int = 1, *, device="cuda") -> Mesh:
    """This rank's place on a (data, mdom=q, mtp=q) mesh with q*q = model
    (the reference's ``make_host_mesh(two_d=True)``).  ``model=1, data=n``
    is the serving mesh of ``serve/engine.py``: n ranks, each the whole
    model, the data group the world.

    A one-rank mesh needs no process group.  Otherwise the process group
    and the card as ``_join`` sets them (the ranks can share one card,
    under gloo); rank d * q * q + i * q + j sits at data index d, mdom
    coordinate i and mtp coordinate j.  Its mdom group (the q ranks of
    column j of its model group) and mtp group (row i) are made with
    ``dist.new_group``, every rank making every group in the same order."""
    q = math.isqrt(model)
    if q * q != model:
        raise ValueError(f"2-D Jigsaw needs a square model mesh; got "
                         f"{model} ranks")
    if model * data == 1:
        return Mesh()
    _join(model * data, torch.device(device),
          f"a (data {data}, {q}x{q}) mesh")
    d, m, model_group, dg = _groups(model, data)
    i, j = divmod(m, q)
    dom = tp = None
    if q > 1:
        base = [e * model for e in range(data)]
        doms = [dist.new_group([b + a * q + c for a in range(q)])
                for b in base for c in range(q)]
        tps = [dist.new_group([b + a * q + c for c in range(q)])
               for b in base for a in range(q)]
        dom, tp = doms[d * q + j], tps[d * q + i]
        if dist.get_rank(dom) != i or dist.get_rank(tp) != j:
            raise RuntimeError("mesh groups are not ordered by coordinate")
    return Mesh(q=q, i=i, j=j, dom_group=dom, tp_group=tp,
                model_group=model_group,
                **_data_fields(data, d, dg, model))
