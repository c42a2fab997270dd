"""Multi-process meshes: the ``torch.distributed`` bootstrap and meshes
whose slow axes are outermost.

Counterpart of ``facerecognition_tpu/parallel/multihost.py``:

- ``initialize_multihost``: ``torch.distributed.init_process_group`` with a
  TCP rendezvous at the coordinator, NCCL for CUDA and gloo for the CPU; it
  also sets this process's card. ``initialize_from_env`` does the same from
  ``torchrun``'s environment.
- ``create_hybrid_mesh``: ``dcn`` axes across hosts (slices), ``ici`` axes
  inside one, the slow axes outermost, as JAX's hybrid mesh orders them.
  ``_plan_hybrid`` is the pure planner (a numpy copy of JAX's).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from facerecognition_tpu_torch.parallel.mesh import Mesh, as_mesh_devices, job_devices


def initialize_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
) -> None:
    """Join a ``num_processes``-rank group as rank ``process_id``, with the
    rendezvous at ``coordinator_address`` (``host:port``). ``backend``:
    ``"nccl"`` where a card is present, else ``"gloo"``. With a card, the
    process drives ``local_device_ids[0]`` (default: its rank modulo the
    visible cards), set before the group starts."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        card = local_device_ids[0] if local_device_ids else process_id % torch.cuda.device_count()
        torch.cuda.set_device(int(card))
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )


def initialize_from_env(backend: Optional[str] = None) -> bool:
    """``initialize_multihost`` from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) when
    it is set and no group is up. Returns whether a group is up after."""
    if dist.is_initialized():
        return True
    env = os.environ
    if "WORLD_SIZE" not in env or "RANK" not in env:
        return False
    initialize_multihost(
        f"{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}",
        int(env["WORLD_SIZE"]),
        int(env["RANK"]),
        [int(env.get("LOCAL_RANK", 0))],
        backend,
    )
    return True


def create_hybrid_mesh(
    dcn: Optional[dict] = None,
    ici: Optional[dict] = None,
    devices: Optional[Sequence] = None,
    slice_of: Optional[Callable] = None,
) -> Mesh:
    """A mesh with ``dcn`` axes across slices (hosts) and ``ici`` axes inside
    one, DCN axes outermost. Each dict maps axis name → size (one ``-1`` a
    dict is inferred): DCN sizes multiply to the slice count, ICI sizes to
    the devices of a slice. ``devices`` default to ``job_devices()``;
    ``slice_of`` maps a device to its slice (default its ``slice_index``,
    0 for every device of one host)."""
    devs = job_devices() if devices is None else as_mesh_devices(list(devices))
    grid, names = _plan_hybrid(devs, dcn, ici, slice_of)
    return Mesh(grid, names)


def _plan_hybrid(
    devices: Sequence,
    dcn: Optional[dict],
    ici: Optional[dict],
    slice_of: Optional[Callable] = None,
) -> tuple[np.ndarray, tuple]:
    """(device grid, axis names) for ``create_hybrid_mesh``: a pure planner,
    tested with synthetic device handles (anything with an ``id``)."""
    dcn = dict(dcn or {})
    ici = dict(ici or {})
    if not ici:
        raise ValueError("need at least one ICI axis")
    if slice_of is None:
        slice_of = lambda d: getattr(d, "slice_index", 0)  # noqa: E731

    slice_ids = sorted({slice_of(d) for d in devices})
    n_slices = len(slice_ids)
    per_slice = len(devices) // n_slices
    if per_slice * n_slices != len(devices):
        raise ValueError(f"uneven slices: {len(devices)} devices over {n_slices} slices")

    def _resolve(sizes: dict, total: int, kind: str) -> dict:
        sizes = dict(sizes)
        vals = list(sizes.values())
        if vals.count(-1) == 1:
            known = math.prod(v for v in vals if v != -1)
            if known == 0 or total % known:
                raise ValueError(f"{kind} sizes {sizes} don't divide {total}")
            sizes[next(k for k, v in sizes.items() if v == -1)] = total // known
        if math.prod(sizes.values()) != total:
            raise ValueError(f"{kind} sizes {sizes} != {total}")
        return sizes

    dcn = _resolve(dcn, n_slices, "dcn") if dcn else {}
    ici = _resolve(ici, per_slice, "ici")

    # (n_slices, per_slice), slices outermost, then the named axis sizes:
    # DCN axes over the slice dimension, ICI axes within.
    by_slice = {s: [] for s in slice_ids}
    for d in devices:
        by_slice[slice_of(d)].append(d)
    grid = np.empty((n_slices, per_slice), dtype=object)
    for row, s in enumerate(slice_ids):
        grid[row, :] = sorted(by_slice[s], key=lambda d: d.id)
    shape = tuple(dcn.values()) + tuple(ici.values())
    names = tuple(dcn.keys()) + tuple(ici.keys())
    return grid.reshape(shape), names
