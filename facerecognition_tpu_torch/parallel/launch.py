"""Start a few ranks of a ``torch.distributed`` group on this host.

``spawn_ranks(fn, world, *args)`` runs ``fn(rank, *args)`` in ``world``
spawned processes joined into one group (``initialize_multihost`` at
``localhost`` on a free port; gloo unless ``backend`` says otherwise) and
returns each rank's return value, rank-major. It is what the CPU tests and
``chip_smoke.py`` use to run the multi-rank paths on one host; a real job
starts its ranks with ``torchrun`` (``multihost.initialize_from_env``).
"""

from __future__ import annotations

import os
import socket
import tempfile
from typing import Callable

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, fn: Callable, world: int, port: int, backend: str, threads: int,
           out_dir: str, args: tuple) -> None:
    import torch.distributed as dist

    from facerecognition_tpu_torch.parallel.multihost import initialize_multihost

    if threads:
        torch.set_num_threads(threads)
    initialize_multihost(f"localhost:{port}", world, rank, backend=backend)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *args, backend: str = "gloo", threads: int = 1) -> list:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own rank of
    a ``world``-rank group; ``threads``: each rank's intra-op threads (0
    leaves PyTorch's default). ``fn`` must be importable by the children
    (a module-level function); its return values pass through
    ``torch.save``. A failing rank raises here."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_entry, args=(fn, world, free_port(), backend, threads, out_dir, args),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
