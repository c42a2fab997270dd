"""Collectives of the data-parallel step and the sharded search, on
``torch.distributed``.

Under gloo a tensor goes through the host for the collective and comes back
to its device; under NCCL it stays on the card. ``AllReduceSum`` and
``GatherRows`` are the differentiable forms: an all-reduced sum whose
gradient is all-reduced too (every rank's output depends on every rank's
input), and a rank-major gather of row blocks whose gradient is each rank's
own block (every rank holds the same loss over the gathered rows, so the
rank's block of its gradient is the whole gradient of its rows).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


def _via_host(t: torch.Tensor) -> bool:
    return dist.get_backend() == "gloo" and t.device.type != "cpu"


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``t`` (a new tensor on ``t``'s device)."""
    buf = t.detach().cpu().clone() if _via_host(t) else t.detach().clone().contiguous()
    dist.all_reduce(buf)
    return buf.to(t.device)


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated rank-major along
    dimension 0, on ``t``'s device."""
    src = t.detach().cpu() if _via_host(t) else t.detach()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` with rank ``src``'s values."""
    if _via_host(t):
        buf = t.detach().cpu()
        dist.broadcast(buf, src)
        t.data.copy_(buf)
    else:
        dist.broadcast(t.data, src)
    return t


class AllReduceSum(torch.autograd.Function):
    """``all_reduce_sum`` whose backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad)


class GatherRows(torch.autograd.Function):
    """``all_gather_cat`` of (n, ...) blocks; the backward keeps this rank's
    block of the gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return all_gather_cat(x)

    @staticmethod
    def backward(ctx, grad):
        start = dist.get_rank() * ctx.rows
        return grad[start:start + ctx.rows]


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's rows of a global batch: ``[start, start + rows)`` of
    ``total`` (``world`` equal slices)."""

    rank: int
    world: int
    total: int

    @property
    def rows(self) -> int:
        return self.total // self.world

    @property
    def start(self) -> int:
        return self.rank * self.rows

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (total, ...) tensor."""
        return t[self.start:self.start + self.rows]


def batch_shard(total: int) -> Optional[BatchShard]:
    """The running group's ``BatchShard`` of a ``total``-row batch; None when
    no group is up. A world size that does not divide ``total`` raises."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if total % world:
        raise ValueError(
            f"the world size {world} does not divide the batch size {total}: "
            "every rank takes an equal slice of the batch"
        )
    return BatchShard(dist.get_rank(), world, total)
