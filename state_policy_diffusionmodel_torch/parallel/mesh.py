"""The process mesh of the port: one process a rank, over torch.distributed.

Counterpart of `state_policy_diffusionmodel_tpu/parallel/mesh.py`. JAX runs
one program over a `jax.sharding.Mesh` of devices, with a `data` axis that
splits batches and envs; here each rank is its own process on its own
device (`Mesh.device`), and the `data` axis is the ranks of the process
group. A batch sharded over `data` is each rank's contiguous block of rows
(`shard_batch`); a replicated tree is a broadcast from rank 0
(`replicate`). JAX's `data_sharding` and `replicated` name shardings of
one program and have no meaning with a process a rank, so they have no
counterpart here.

Backends: `make_mesh` takes NCCL on "cuda" and gloo on "cpu". Gloo on
"cuda" lets two ranks share one card (NCCL refuses two ranks on one GPU),
and `launch.launch(..., backend="gloo")` sets it up;
gloo runs only `broadcast` and `all_reduce` on CUDA tensors, so those are
the only collectives this package runs on device tensors, and whatever is
gathered (`gather_rows`) goes through CPU tensors unless the backend is
NCCL.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the `data` axis: its rank, the number of
    ranks, its device and the process group (None for the one-process
    mesh, which runs no collective)."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_device(device, local_rank: int) -> torch.device:
    """`device` with the rank's card index where it names none."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return resolve_device(dev)


def make_mesh(device="cuda") -> Mesh:
    """The mesh this process belongs to:
    - under torchrun (RANK and WORLD_SIZE set): the default group, created
      here if it is not yet (NCCL on "cuda", gloo on "cpu"),
      with the rank's device cuda:LOCAL_RANK;
    - else, if the default group is initialized: that group (its creator
      chose the backend), on `device`;
    - else the one-process mesh: world size 1, no group."""
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dev = _rank_device(device, local_rank)
        if not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(default_backend(dev),
                                    init_method="env://",
                                    rank=int(os.environ["RANK"]),
                                    world_size=int(os.environ["WORLD_SIZE"]))
    elif dist.is_initialized():
        dev = _rank_device(device, local_rank)
    else:
        return Mesh(0, 1, resolve_device(device))
    return Mesh(dist.get_rank(), dist.get_world_size(), dev,
                dist.group.WORLD)


def _map(fn, tree):
    """fn on every tensor and array leaf of dicts, lists and tuples
    (NamedTuples kept); other leaves (ints, None) as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def rows(n: int, mesh: Mesh) -> slice:
    """The rank's contiguous block of n rows, as P("data") splits them;
    n must divide by the world size."""
    if n % mesh.world_size:
        raise ValueError(f"{n} rows do not split over {mesh.world_size} "
                         "ranks")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch, mesh: Mesh):
    """The rank's rows of every tensor or array leaf (leading axis split over
    the ranks); the leaves keep their devices."""
    return _map(lambda x: x[rows(x.shape[0], mesh)], batch)


def replicate(params, mesh: Mesh):
    """Rank 0's values on every rank, in place: every parameter and buffer
    of each module (or every tensor leaf) broadcast from rank 0. Returns
    `params`."""
    if mesh.group is None:
        return params
    tensors = []
    for leaf in (params.values() if isinstance(params, dict) else [params]):
        if isinstance(leaf, torch.nn.Module):
            tensors += [*leaf.parameters(), *leaf.buffers()]
        else:
            _map(tensors.append, leaf)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, 0, group=mesh.group)
    return params


def pad_to_multiple(batch, multiple: int):
    """Pad the leading axis of every leaf to a multiple of `multiple` by
    repeating the last row; returns (padded batch, real size). numpy
    leaves, as the JAX function pads them."""
    sizes = set()
    _map(lambda x: sizes.add(x.shape[0]), batch)
    assert len(sizes) == 1, sizes
    n = sizes.pop()
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    return _map(lambda x: np.concatenate([x, np.repeat(x[-1:], rem, 0)], 0),
                batch), n


def all_reduce_mean_(tensors, mesh: Mesh) -> None:
    """Each tensor replaced, in place, by its mean over the ranks: one flat
    bucket, summed and divided by the world size. Nothing runs without a
    group."""
    if mesh.group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    flat /= mesh.world_size
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def mean_over_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A new tensor: x's mean over the ranks (x itself without a group)."""
    if mesh.group is None:
        return x
    x = x.detach().clone()
    all_reduce_mean_([x], mesh)
    return x


def gather_rows(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order, on every rank,
    on x's device. Through CPU tensors, unless the backend is NCCL (which
    gathers CUDA tensors only)."""
    if mesh.group is None:
        return x
    via = x if mesh.backend == "nccl" else x.detach().cpu()
    via = via.contiguous()
    parts = [torch.empty_like(via) for _ in range(mesh.world_size)]
    dist.all_gather(parts, via, group=mesh.group)
    return torch.cat(parts, dim).to(x.device)


def barrier(mesh: Mesh) -> None:
    if mesh.group is not None:
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)
