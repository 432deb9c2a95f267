"""Start the ranks of a sharded render on one host, and the CLI's rank.

``spawn(fn, world_size, backend, *args)`` runs ``fn(rank, world_size,
*args)`` in ``world_size`` processes (``torch.multiprocessing.spawn``), each
joined to one process group through a ``FileStore`` in a temporary
directory: no port to pick, so runs side by side (pytest-xdist) never
collide.  A rank that raises fails the spawn: the others are stopped and
the caller gets the error.

A spawned rank imports ``fn`` by its module's name, so ``fn`` lives in a
module that imports nothing of JAX: :func:`cli_render_worker` here is
``render --mesh``'s rank (``harness/cli.py``).

Devices: ``device="cpu"`` puts every rank on the CPU (gloo); under NCCL rank
r takes ``cuda:r``, and fewer GPUs than ranks raises; under gloo with CUDA
the ranks share the GPUs round robin (all of them ``cuda:0`` on one card),
and the gathers go through the host.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a rank that waits this long in a collective gives up, so a fault on one
# rank ends the run instead of hanging it
TIMEOUT = datetime.timedelta(minutes=5)


def rank_device(rank: int, backend: str, device=None) -> torch.device:
    """The device of ``rank``: the CPU when ``device`` names it, else a GPU
    as the module docstring says."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    n = torch.cuda.device_count()
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % n)


def check_devices(world_size: int, backend: str, device=None) -> None:
    """Raise before any rank starts when NCCL has fewer GPUs than ranks
    (NCCL takes one GPU per rank) or runs on the CPU."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if backend == "nccl":
        if cpu:
            raise ValueError("the nccl backend runs on GPUs; use gloo for "
                             "--device cpu")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < world_size:
            raise RuntimeError(
                f"the nccl backend takes one GPU per rank: {world_size} ranks "
                f"but {n} GPUs; use --backend gloo to share a GPU")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")


def _entry(rank, fn, world_size, backend, store_path, args):
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", rank)
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=TIMEOUT, **kw)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str, *args) -> None:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` ranks of one
    process group (``backend`` nccl or gloo) and wait for all of them."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_entry, args=(fn, world_size, backend,
                               os.path.join(tmp, "store"), args),
                 nprocs=world_size, join=True)


def cli_render_worker(rank: int, world_size: int, args) -> None:
    """One rank of the CLI's ``render --mesh``: builds the scene on its
    device, renders the sharded frame; rank 0 writes the PNG."""
    from ..harness import cli

    cli.render_rank(rank, args)
