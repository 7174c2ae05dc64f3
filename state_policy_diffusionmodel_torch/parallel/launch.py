"""Run a function in n ranks, one spawned process each.

`launch(fn, n, device)` starts n processes with the `spawn` start method
(which CUDA needs), joins them into one process group through a `file://`
rendezvous in a fresh temporary directory (no TCP port to race for), and
calls `fn(mesh, *args)` in each, with `mesh` the rank's `Mesh`. It returns
the ranks' return values in rank order. A rank that raises fails the
launch with that rank's traceback; ranks still running at `timeout`
seconds are terminated and the launch raises, so a hung collective never
waits forever.

Devices: "cpu"; "cuda" (rank r on cuda:r, NCCL by default); or one card
such as "cuda:0" for every rank, where the backend must be gloo (NCCL
refuses two ranks on one GPU).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import Mesh, default_backend


def _rank_main(rank: int, fn: Callable, n: int, device: str, backend: str,
               init_file: str, out_dir: str, threads: int, args: tuple):
    torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=n)
    try:
        out = fn(Mesh(rank, n, dev, dist.group.WORLD), *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, device="cpu", args: tuple = (),
           backend: Optional[str] = None, timeout: float = 300.0,
           threads: int = 1) -> list:
    """fn(mesh, *args) in n spawned ranks; their return values (which must
    pickle, tensors on the CPU) in rank order."""
    backend = backend or default_backend(device)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None and n > 1 \
            and backend == "nccl":
        raise ValueError(f"{n} ranks on {dev} need gloo: NCCL refuses two "
                         "ranks on one GPU")
    work = tempfile.mkdtemp(prefix="spdm_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, n, str(dev), backend,
                              os.path.join(work, "rendezvous"), work,
                              threads, tuple(args)),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, min(
                1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{n} ranks of {getattr(fn, '__name__', fn)}"
                                   f" still ran after {timeout} s")
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
