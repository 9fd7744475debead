"""The mesh: a process group standing in for the JAX package's device `Mesh`.

One rank is one process with one device.  A `Mesh` holds the group, the
rank within it, the world size, the rank's explicit `torch.device` and the
axis name; its collectives are the JAX package's named ones:

  * `reduce(t)`: a sum all-reduce (`psum`), the `reduce` hook the
    objectives and the pose-graph solve take;
  * `all_gather(t)`: the ranks' rows in rank order (`all_gather(tiled)`);
  * `all_to_all(t)`: block r of t goes to rank r, block r of the result
    comes from rank r (`all_to_all(tiled)`).

NCCL takes CUDA tensors; gloo takes CPU tensors and, staging them through
the host itself, CUDA tensors for all three (checked with torch
2.11.0+cu128): a gloo mesh on CUDA tensors is how two ranks share one card,
since NCCL refuses two ranks on one device.  The kernels stay on the card
either way.

`stats` counts, since `reset_stats()`, the collectives this process ran
(by kind) and the bytes it sent into them.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import device as _device

DATA_AXIS = "data"

stats = {}


def reset_stats() -> None:
    """Set the collective counters to 0."""
    stats.clear()
    stats.update(collectives=0, bytes=0, all_reduce=0, all_gather=0, all_to_all=0)


reset_stats()


def _count(kind, t):
    stats["collectives"] += 1
    stats[kind] += 1
    stats["bytes"] += t.numel() * t.element_size()


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks: the group (None: the default group), this
    process's rank in it, its size, the rank's device, the axis name and the
    group's backend."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = DATA_AXIS
    backend: str = "gloo"

    @property
    def shape(self):
        """{axis: size}, as a JAX mesh's `shape`."""
        return {self.axis: self.size}

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks, in place (t must be contiguous and owned
        by the caller); returns t."""
        _count("all_reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t (equal shapes), concatenated along dim 0 in rank
        order."""
        t = t.contiguous()
        _count("all_gather", t)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t (size * c, ...): block r (rows r c to (r + 1) c) goes to rank
        r; returns the blocks received, block r from rank r."""
        t = t.contiguous()
        _count("all_to_all", t)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def max_int(self, v: int) -> int:
        """The largest of the ranks' host integers (one all-gather)."""
        return int(self.all_gather(torch.tensor([int(v)], dtype=torch.int64,
                                                device=self.device)).max())

    def barrier(self) -> None:
        """Wait for every rank (a one-float all-reduce on the mesh's device)."""
        self.reduce(torch.zeros(1, device=self.device))


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def rank_device(dev: torch.device) -> torch.device:
    """`dev` with an explicit index: a CUDA device without one is the
    process's local rank (LOCAL_RANK, else the global rank) modulo the
    visible cards."""
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def build(n_devices, axis, device, backend) -> Mesh | None:
    """The mesh over the first `n_devices` ranks of the default group (all
    of them by default); a world of one is made first where no group
    exists (`distributed.initialize`).  Every rank of the default group
    must call it; a rank outside a smaller mesh gets None."""
    from .distributed import initialize

    dev = _device.resolve(device)
    if not dist.is_initialized():
        initialize(backend=backend, device=dev)
    world = dist.get_world_size()
    group = None
    if n_devices is not None and n_devices != world:
        if not 1 <= n_devices <= world:
            raise ValueError(f"n_devices {n_devices} outside 1..{world}")
        group = dist.new_group(ranks=list(range(n_devices)), backend=backend)
        if dist.get_rank() >= n_devices:
            return None
    return Mesh(group=group, rank=dist.get_rank(group), size=dist.get_world_size(group),
                device=rank_device(dev), axis=axis, backend=dist.get_backend(group))
