"""Process-group set-up for data parallelism
(wise_tpu/parallel/distributed.py).

The reference initialises ``jax.distributed`` from its coordinator's
environment. The port's ranks are processes under ``torch.distributed``:
torchrun's environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), or the same variables set by
:func:`spawn`, which the train CLI's ``--dp N`` uses to start N ranks
itself.

A rank's device is the ``LOCAL_RANK``-th of the mesh's devices, round and
round (``utils/device.py`` ``default_devices``: every visible card, or
``$WISE_TORCH_DEVICE``'s list). The backend follows the devices:

- NCCL when every rank of the host has a card of its own;
- gloo when ranks share a card or run on the CPU. NCCL refuses two ranks
  on one card ("Duplicate GPU detected"); gloo reduces CUDA tensors too
  (``all_reduce`` and ``broadcast``, all that the trainer needs).

The choice is printed, and an NCCL failure raises: nothing drops to gloo
on its own.

Usage (one call at program start in every rank):

    from wise_tpu_torch.parallel import distributed
    distributed.maybe_initialize_distributed()
"""

from __future__ import annotations

import logging
import os
import socket

import torch

from ..utils.device import default_devices

logger = logging.getLogger(__name__)

_initialized = False


def world_env() -> tuple:
    """(world size, rank, local rank) from the environment (1, 0, 0 when
    unset)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    return world, rank, int(os.environ.get("LOCAL_RANK", str(rank)))


def rank_device(local_rank: int, devices=None) -> torch.device:
    """The device of the rank with ``local_rank``: the mesh's devices in
    turn."""
    devices = list(devices if devices is not None else default_devices())
    return torch.device(devices[local_rank % len(devices)])


def choose_backend(local_world: int, devices=None) -> str:
    """``nccl`` when each of ``local_world`` ranks has a card of its own,
    ``gloo`` when ranks share a device or run on the CPU."""
    ranks = {rank_device(r, devices) for r in range(local_world)}
    cards = all(d.type == "cuda" for d in ranks)
    return "nccl" if cards and len(ranks) == local_world else "gloo"


def maybe_initialize_distributed() -> bool:
    """Initialise the default process group when the environment names
    more than one rank, with the backend :func:`choose_backend` picks, and
    make the rank's card current. Returns True if running multi-process."""
    global _initialized
    if _initialized:
        return True
    world, rank, local_rank = world_env()
    if world <= 1:
        return False
    import torch.distributed as dist

    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    device = rank_device(local_rank)
    backend = choose_backend(local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ["MASTER_PORT"]
    why = ("a card a rank" if backend == "nccl"
           else "ranks share a device or run on the CPU")
    print(f"[dp] rank {rank}/{world} on {device}: backend {backend} ({why})",
          flush=True)
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank)
    _initialized = True
    logger.info(f"torch.distributed initialised: rank {rank}/{world}, "
                f"{backend} on {device}")
    return True


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(local_rank: int, world: int, port: int, fn, args) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(local_rank),
                      LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    maybe_initialize_distributed()
    try:
        fn(*args)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def spawn(fn, world: int, *args) -> None:
    """Run ``fn(*args)`` in ``world`` new processes on this host, each a
    rank of one process group on localhost (:func:`maybe_initialize_
    distributed`); ``fn`` must be importable by name. Raises when a rank
    fails, after every rank has ended."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_entry, args=(world, free_port(), fn, args),
                       nprocs=world, join=True, start_method="spawn")
