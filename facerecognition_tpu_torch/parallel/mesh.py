"""Device meshes: named grids of devices.

Counterpart of ``facerecognition_tpu/parallel/mesh.py``. Axis convention:
``data`` splits a training batch, ``gallery`` splits a gallery's rows. A
``Mesh`` holds ``MeshDevice`` entries (an id, a ``torch.device`` and the
rank of the process that owns it) in a numpy grid with JAX's ``shape``
mapping and axis rules: one ``-1`` size is inferred, and the sizes must
multiply to the device count.

Devices default to ``job_devices()``: this process's CUDA cards (raising
without one); once a
``torch.distributed`` group is up (``multihost.initialize_multihost``, or
``torchrun``'s environment) they are every rank's cards, rank-major, as
``jax.devices()`` lists every host's chips after ``jax.distributed.
initialize``. Each process acts on its own entries (``Mesh.local``). The
CPU tests pass ``torch.device("cpu")`` entries as virtual devices, as the
JAX suite runs on virtual CPU devices. Several entries may name one card
(a gallery cut into shards on one card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from facerecognition_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshDevice:
    """One device of a mesh: its id in the mesh's device list, the torch
    device, and the rank of the process that owns it."""

    id: int
    device: torch.device
    process_index: int = 0
    slice_index: int = 0


DeviceEntry = Union[MeshDevice, torch.device, str]


def group_size() -> int:
    """The world size of the default ``torch.distributed`` group (1 when
    none is up)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group (0 when none is up)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_cuda_devices() -> list[torch.device]:
    """The cards this process drives: every visible card, or with a group
    up the one ``initialize_multihost`` / ``torchrun`` set (one card a
    rank). Raises without a card."""
    resolve_device(None)  # raises without a card (CPU meshes list their devices)
    if dist.is_initialized():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def job_devices() -> list[MeshDevice]:
    """Every device of the job, rank-major: this process's cards, or with a
    group up each rank's (gathered from the ranks)."""
    local = [str(d) for d in local_cuda_devices()]
    per_rank = [local]
    if dist.is_available() and dist.is_initialized():
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, local)
    out = []
    for rank, names in enumerate(per_rank):
        for name in names:
            out.append(MeshDevice(len(out), torch.device(name), rank))
    return out


def as_mesh_devices(entries: Sequence[DeviceEntry]) -> list[MeshDevice]:
    """``MeshDevice``s as given; ``torch.device`` (or string) entries become
    this process's devices with ids in order."""
    out = []
    for i, d in enumerate(entries):
        if isinstance(d, MeshDevice):
            out.append(d)
        else:
            out.append(MeshDevice(i, torch.device(d), process_index()))
    return out


class Mesh:
    """A named grid of ``MeshDevice``s (``jax.sharding.Mesh``'s shape)."""

    def __init__(self, grid: np.ndarray, axis_names: Sequence[str]):
        grid = np.asarray(grid, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-D device grid for axes {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local(self, axis: str) -> list[tuple[int, MeshDevice]]:
        """This process's devices along ``axis``: (position on the axis,
        device), in axis order; one entry a position (the first of the
        process's devices there)."""
        k = self.axis_names.index(axis)
        moved = np.moveaxis(self.devices, k, 0).reshape(self.devices.shape[k], -1)
        me = process_index()
        out = []
        for pos in range(moved.shape[0]):
            mine = [d for d in moved[pos] if d.process_index == me]
            if mine:
                out.append((pos, mine[0]))
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def create_mesh(devices: Optional[Sequence[DeviceEntry]] = None, **axis_sizes: int) -> Mesh:
    """A named mesh over ``devices`` (default: ``job_devices()``).

    ``create_mesh(data=4, gallery=2)`` is a 4x2 mesh. The sizes must multiply
    to the device count; one size of -1 is inferred.
    """
    devs = job_devices() if devices is None else as_mesh_devices(list(devices))
    names = tuple(axis_sizes)
    sizes = list(axis_sizes.values())
    n = len(devs)
    if sizes.count(-1) == 1:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known if known else 0
    if math.prod(sizes) != n:
        raise ValueError(f"axis sizes {dict(zip(names, sizes))} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(sizes), names)


def local_mesh(axis: str = "data") -> Mesh:
    """A 1-D mesh over every device (the common one-host case)."""
    return create_mesh(**{axis: -1})


def resolve_data_mesh(num_devices, batch_size: int, device=None) -> Optional[Mesh]:
    """A trainer's ``train.num_devices`` as a ``data`` mesh over the ranks
    of the ``torch.distributed`` group, one device a rank, or None.

    None, 0, 1 or False: no data parallelism. ``"auto"``: the group's world
    size (None when no group is up); an int must equal it (processes cannot
    be dropped as JAX drops devices: start that many ranks with ``torchrun``).
    A world size that does not divide ``batch_size`` raises: every rank takes
    an equal slice of the global batch. ``device``: this rank's device
    (default its current card); the other ranks' entries carry their rank
    only (``torch.device("meta")``).
    """
    if num_devices in (None, 0, 1, False):
        return None
    up = dist.is_available() and dist.is_initialized()
    world = group_size()
    if num_devices != "auto" and int(num_devices) != world:
        raise ValueError(
            f"train.num_devices={num_devices} needs a torch.distributed group of "
            f"{num_devices} ranks (torchrun --nproc_per_node {num_devices}); "
            f"this process's group has {world}"
        )
    if not up:
        return None
    if batch_size % world:
        raise ValueError(
            f"the world size {world} does not divide the batch size {batch_size}: "
            "every rank takes an equal slice of the batch"
        )
    me = process_index()
    mine = torch.device(device) if device is not None else local_cuda_devices()[0]
    entries = [MeshDevice(r, mine if r == me else torch.device("meta"), r) for r in range(world)]
    return create_mesh(entries, data=world)
