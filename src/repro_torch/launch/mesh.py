"""Mesh construction: the reference's ``repro/launch/mesh.py`` on
``torch.distributed.device_mesh``.

Functions, not module-level constants: importing touches no process group.
A production mesh needs a default process group of ``required_devices``
ranks (one process a card, or the dry run's fake group); the host mesh
starts a one-rank group itself when none is running.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "required_devices"]

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def required_devices(*, multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """16x16 single-pod (data, model) or 2x16x16 (pod, data, model) over
    the default process group, which must hold ``required_devices``
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type="cuda"):
    """A (data=1, model=1) mesh on one device: the card unless the caller
    names another type.  Starts a one-rank process group (``nccl`` on the
    card, ``gloo`` on the CPU) when none is running; a running group must
    have one rank."""
    if device_type == "cuda":   # the mesh's communicators on this card
        torch.cuda.set_device(torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group(_BACKEND.get(device_type, "gloo"),
                                store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError("make_host_mesh needs a one-rank process group, "
                         f"not {dist.get_world_size()} ranks")
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))
