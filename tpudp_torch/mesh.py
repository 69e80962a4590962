"""Process groups for the port — the counterpart of ``tpudp/mesh.py``.

Where the JAX package builds one :class:`jax.sharding.Mesh` over every
device and reduces over its ``data`` axis, the port runs one process a
rank and reduces over a ``torch.distributed`` process group: the
default group stands where JAX has ``DATA_AXIS``.  NCCL carries the
collectives between CUDA ranks, gloo between CPU ranks.

:func:`initialize_distributed` maps the reference's ``--master``,
``--num-nodes`` and ``--rank`` (port 6585) onto ``init_process_group``;
:func:`make_mesh` describes the group a train step reduces over.

:func:`make_mesh_nd` is JAX's N-D mesh for the sharded rungs
(``tpudp_torch.strategy``): a ``torch.distributed.device_mesh`` over the
world with JAX's axis names, ranks laid out row-major as JAX reshapes its
devices, and one process group an axis.  Where JAX binds an axis inside
``shard_map``, the port binds it with :func:`bind_axes`: the layers that
talk over an axis (ring attention over ``seq``, the MoE MLP over
``expert``) find its group with :func:`axis_group` and run their dense
form where it is unbound (``tpudp/mesh.py`` ``axis_is_bound``).
"""

from __future__ import annotations

import contextlib
import math
import socket
from dataclasses import dataclass, field

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


@dataclass(frozen=True)
class MeshND:
    """An N-D mesh over the default process group: ``shape`` maps axis
    names to sizes (insertion-ordered, as JAX's), ``rank`` is this
    process's rank, ``coords`` its index along each axis (row-major:
    ``rank = sum(coords[a] * stride[a])``) and ``groups`` the process
    group of each axis that holds this rank."""

    shape: dict
    rank: int
    coords: dict
    groups: dict = field(repr=False)
    device_mesh: object = field(repr=False, default=None)

    def group(self, axis: str):
        """The process group of ``axis`` that holds this rank."""
        if axis not in self.shape:
            raise ValueError(f"mesh {dict(self.shape)} has no axis {axis!r}")
        return self.groups[axis]


def make_mesh_nd(shape: dict, device_type: str | None = None) -> MeshND:
    """JAX's ``make_mesh_nd({axis: size})`` over the default process group
    (initialized first with :func:`initialize_distributed`): the product
    of the sizes must be the world size.  Rank r sits where JAX puts
    device r of ``devices.reshape(sizes)``, so it holds the batch rows
    JAX's device r holds.  ``device_type`` names the mesh's device
    (default: ``'cuda'`` under NCCL, ``'cpu'`` under gloo, whose groups
    also carry CUDA tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first")
    shape = {str(k): int(v) for k, v in shape.items()}
    if not shape or min(shape.values()) < 1:
        raise ValueError(f"mesh shape {shape} needs axes of size >= 1")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape.values())} "
                         f"ranks; the process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(shape.values()),
                          mesh_dim_names=tuple(shape))
    coords, rest = {}, rank
    for axis in reversed(shape):
        coords[axis] = rest % shape[axis]
        rest //= shape[axis]
    coords = {a: coords[a] for a in shape}
    groups = {a: dm.get_group(a) for a in shape}
    return MeshND(shape=shape, rank=rank, coords=coords, groups=groups,
                  device_mesh=dm)


# Axis name -> process group, for the layers that talk over a mesh axis:
# the counterpart of the axes JAX binds inside shard_map.
_BOUND: dict = {}


@contextlib.contextmanager
def bind_axes(axes: dict):
    """Bind ``{axis name: process group}`` for the duration of the block
    (the rung's forward and backward run inside it)."""
    saved = dict(_BOUND)
    _BOUND.update(axes)
    try:
        yield
    finally:
        _BOUND.clear()
        _BOUND.update(saved)


def axis_group(axis_name: str | None):
    """The process group bound to ``axis_name`` by :func:`bind_axes`, or
    None when the axis is unbound (JAX: ``axis_is_bound`` is false)."""
    if axis_name is None:
        return None
    return _BOUND.get(axis_name)


def axis_is_bound(axis_name: str | None) -> bool:
    """True inside :func:`bind_axes` with ``axis_name`` bound."""
    return axis_group(axis_name) is not None
