"""Process-group set-up for data and tensor parallelism
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

Under tensor parallelism (``--mp M``) the world is dp x mp ranks, rank
``d * mp + m``: mp innermost, as the reference's ``reshape(dp, mp)`` lays its
mesh out. :func:`parallel_groups` gives a rank its 'dp' group (the ranks
that hold the same shard and split the batch) and its 'mp' group as a
:class:`TensorParallel`, which carries the two Megatron functions the
head-split blocks use (ops/block.py, models/clip/model.py): ``copy``,
identity forward and ``all_reduce`` of the cotangent backward, and
``reduce``, ``all_reduce`` forward and identity backward. Both reduce in
f32.

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


class _Copy(torch.autograd.Function):
    """Identity forward; the cotangent summed over the 'mp' ranks backward
    (each rank's heads add their part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.reduce_cotangent(g), None


class _Reduce(torch.autograd.Function):
    """The 'mp' ranks' partials summed in f32 forward; identity backward
    (every rank's partial gets the whole output's cotangent)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Take(torch.autograd.Function):
    """``x[..., index]`` of a replicated leaf (a column-split layer's bias)
    forward; backward the rank's columns scattered into zeros and summed
    over the 'mp' ranks, so that the leaf's gradient is whole and the same
    on every rank."""

    @staticmethod
    def forward(ctx, x, index, tp):
        ctx.save_for_backward(index)
        ctx.shape, ctx.tp = x.shape, tp
        return x.index_select(-1, index)

    @staticmethod
    def backward(ctx, g):
        index, = ctx.saved_tensors
        full = g.new_zeros(ctx.shape).index_add_(-1, index, g)
        return ctx.tp.all_reduce(full).to(g.dtype), None, None


class TensorParallel:
    """A rank's 'mp' group: ``size`` ranks, this one the ``rank``-th, over
    ``group`` (a ``torch.distributed`` group; None with one rank, where every
    collective is the identity).

    The head-split layout: a layer split by output column gives rank m the
    m-th of ``size`` equal column ranges (``columns``); the attention's
    in-projection (D, 3D) = [q | k | v] gives it heads [m H/mp, (m+1) H/mp)
    of each of q, k and v, packed as its own (D, 3E), E = D / mp
    (``qkv_columns``); a layer split by input row, the m-th row range.
    parallel/train.py's shard and gather functions apply it to a state
    dict; the blocks take their biases' columns through ``take``."""

    def __init__(self, size: int = 1, rank: int = 0, group=None):
        self.size, self.rank, self.group = int(size), int(rank), group

    def columns(self, n: int) -> slice:
        """The rank's range of ``n`` columns (or rows)."""
        if n % self.size:
            raise ValueError(f"{n} columns do not split over mp = "
                             f"{self.size}")
        e = n // self.size
        return slice(self.rank * e, (self.rank + 1) * e)

    def qkv_columns(self, width: int, device=None) -> torch.Tensor:
        """The in-projection's columns of the rank's heads, (3E,) int64:
        its q, then its k, then its v columns."""
        cols = self.columns(width)
        return torch.cat([torch.arange(cols.start, cols.stop, device=device)
                          + part * width for part in range(3)])

    def all_reduce(self, x) -> torch.Tensor:
        """The sum of ``x`` over the ranks, in f32 (a new tensor)."""
        out = x.to(torch.float32, copy=True).contiguous()
        if self.size > 1:
            import torch.distributed as dist

            dist.all_reduce(out, group=self.group)
        return out

    def reduce_cotangent(self, g) -> torch.Tensor:
        """The cotangent of a replicated activation that the ranks' heads
        read: the ranks' parts ``g`` (each formed in f32 by its caller)
        summed over the ranks in f32 and cast back to g's dtype, which the
        caller rounds once into the activation's. The one collective of a
        head-split block's backward."""
        if self.size == 1:
            return g
        return self.all_reduce(g).to(g.dtype)

    def copy(self, x):
        """Identity forward, :meth:`reduce_cotangent` backward."""
        return x if self.size == 1 else _Copy.apply(x, self)

    def reduce(self, x):
        """The sum of the ranks' partials (f32) forward, identity
        backward."""
        return x.float() if self.size == 1 else _Reduce.apply(x, self)

    def take(self, x, index):
        """``x[..., index]`` with a gradient summed over the ranks."""
        if self.size == 1:
            return x.index_select(-1, index)
        return _Take.apply(x, index, self)


#: one process, no split
NO_SPLIT = TensorParallel()


def parallel_groups(mp: int):
    """(the 'dp' group, the 'mp' group as a :class:`TensorParallel`) of this
    rank in a world of dp x mp ranks, rank ``d * mp + m``. Every rank makes
    every group, in one order, as ``new_group`` asks."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if mp < 1 or world % mp:
        raise ValueError(f"{world} ranks do not split into mp = {mp}")
    dp = world // mp
    d, m = divmod(rank, mp)
    mine = {}
    for i in range(dp):
        g = dist.new_group([i * mp + j for j in range(mp)])
        if i == d:
            mine["mp"] = g
    for j in range(mp):
        g = dist.new_group([i * mp + j for i in range(dp)])
        if j == m:
            mine["dp"] = g
    return mine["dp"], TensorParallel(mp, m, mine["mp"])


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
