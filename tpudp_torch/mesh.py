"""Process groups for the port — the counterpart of ``tpudp/mesh.py``.

Where the JAX package builds one :class:`jax.sharding.Mesh` over every
device and reduces over its ``data`` axis, the port runs one process a
rank and reduces over a ``torch.distributed`` process group: the
default group stands where JAX has ``DATA_AXIS``.  NCCL carries the
collectives between CUDA ranks, gloo between CPU ranks.

:func:`initialize_distributed` maps the reference's ``--master``,
``--num-nodes`` and ``--rank`` (port 6585) onto ``init_process_group``;
:func:`make_mesh` describes the group a train step reduces over.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

PORT = 6585  # the reference's rendezvous port


def free_port() -> int:
    """A TCP port on localhost that is free now (for a local rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(device, num_processes: int = 1,
                           process_id: int = 0, *,
                           init_method: str | None = None) -> None:
    """Join (or, at one process, create) the default process group: NCCL
    for a CUDA ``device``, gloo for the CPU.

    ``init_method`` is the rendezvous of a multi-process run:
    ``tcp://<--master>:6585`` as the reference's ranks meet,
    ``tcp://127.0.0.1:<free port>`` for local ranks, ``file://`` in the
    tests.  At one process and without one, the group is this process
    alone over an in-process store — no socket is opened.  A group that
    is already initialized is kept."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if init_method is None:
        if num_processes != 1:
            raise ValueError(f"{num_processes} processes need an "
                             "init_method to meet at")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
        return
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


@dataclass(frozen=True)
class Mesh:
    """The data-parallel world a train step reduces over: the default
    process group's size and this process's rank."""

    size: int
    rank: int


def make_mesh(num_devices: int | None = None) -> Mesh:
    """The default process group as a :class:`Mesh` (initialized first
    with :func:`initialize_distributed`).  ``num_devices``, as in JAX,
    asks for that many ranks: it must equal the world size."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"requested {num_devices} devices but the process "
                         f"group has {world} ranks")
    return Mesh(size=world, rank=dist.get_rank())
