"""Device mesh helpers (wise_tpu/parallel/mesh.py).

The mesh has the reference's ``dp`` axis: row sharding for the index scan
(parallel/sharded_search.py: each device scans its shard, and the per-shard
top-k candidates are merged on the first device). The data-parallel trainer
runs one process a rank instead (parallel/distributed.py). The reference's
``mp`` axis and its ``('pp', 'dp')`` mesh come with tensor and pipeline
parallelism (ROADMAP Queue A item 12).

The reference's ``jax.sharding.Mesh`` is a small class here, the list of the
``dp`` devices, and a sharded array is the list of its shards, one tensor a
device. The default devices are every visible card, or
``$WISE_TORCH_DEVICE``'s list (``utils/device.py``); a device may appear more
than once, so one card can hold several shards.
"""

from __future__ import annotations

import torch

from ..utils.device import default_devices


class Mesh:
    """``devices``: the ``torch.device`` of each shard along 'dp'."""

    axis_names = ("dp",)

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices)}


def get_mesh(dp: int = -1, devices=None) -> Mesh:
    """The first ``dp`` of ``devices`` (all of them with -1; by default the
    visible cards or ``$WISE_TORCH_DEVICE``'s list)."""
    devices = list(devices if devices is not None else default_devices())
    if dp == -1:
        dp = len(devices)
    if dp > len(devices):
        raise ValueError(f"mesh of {dp} needs {dp} devices, have "
                         f"{len(devices)}")
    return Mesh(devices[:dp])


def shard_rows(mesh: Mesh, arr, axis: int = 0) -> list:
    """An array split along ``axis`` into one piece a 'dp' device, each
    piece on its device (the axis must divide evenly, as the reference's
    sharding requires)."""
    t = torch.as_tensor(arr)
    ndev = mesh.shape["dp"]
    if t.shape[axis] % ndev:
        raise ValueError(f"axis {axis} of size {t.shape[axis]} does not "
                         f"divide over dp = {ndev}")
    return [piece.to(dev).contiguous() for piece, dev in
            zip(torch.chunk(t, ndev, dim=axis), mesh.devices)]


def replicate(mesh: Mesh, arr) -> list:
    """``arr`` on every 'dp' device, one copy a distinct device (shards on
    one device share it): the reference's replicated sharding."""
    t = torch.as_tensor(arr)
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = t.to(dev)
    return [copies[dev] for dev in mesh.devices]
