"""Device mesh helpers (wise_tpu/parallel/mesh.py).

The reference's meshes, with their axes:

- ``('dp', 'mp')`` (:func:`get_mesh`): ``dp`` is row sharding for the index
  scan (parallel/sharded_search.py: each device scans its shard, and the
  per-shard top-k candidates are merged on the first device) and the batch
  of the trainer; ``mp`` is tensor parallelism. The trainers run one process
  a rank (parallel/distributed.py, rank ``d * mp + m`` on the mesh's device
  ``[d, m]``).
- ``('pp', 'dp')`` (:func:`get_pp_mesh`): pipeline stages along ``pp``
  (parallel/pipeline.py), the batch along ``dp``. One process drives the
  stages of its ``dp`` column.

The reference's ``jax.sharding.Mesh`` is a small class here: a grid of
devices by axis, and a sharded array is the list of its shards, one tensor a
device. The default devices are every visible card, or
``$WISE_TORCH_DEVICE``'s list (``utils/device.py``); a device may appear more
than once, so one card can hold several shards, ``mp`` ranks or pipeline
stages.
"""

from __future__ import annotations

import math

import torch

from ..utils.device import default_devices


class Mesh:
    """``devices``: the ``torch.device`` of each point of the grid, in row
    order; ``axis_names`` and ``sizes`` the grid's axes (one 'dp' axis of
    every device by default)."""

    def __init__(self, devices, axis_names=("dp",), sizes=None):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(sizes or (len(self.devices),))
        if math.prod(self.sizes) != len(self.devices) or len(
                self.sizes) != len(self.axis_names):
            raise ValueError(f"a {self.sizes} grid of axes "
                             f"{self.axis_names} over {len(self.devices)} "
                             "devices")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def device(self, **index) -> torch.device:
        """The device at ``index`` (one int an axis; an axis left out is 0)."""
        flat = 0
        for name, size in zip(self.axis_names, self.sizes):
            flat = flat * size + index.get(name, 0)
        return self.devices[flat]


def _grid(devices, sizes, names) -> Mesh:
    devices = list(devices if devices is not None else default_devices())
    n = math.prod(sizes)
    if n > len(devices):
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} needs {n} "
                         f"devices, have {len(devices)}")
    return Mesh(devices[:n], names, sizes)


def get_mesh(dp: int = -1, mp: int = 1, devices=None) -> Mesh:
    """The first dp x mp of ``devices`` (by default the visible cards or
    ``$WISE_TORCH_DEVICE``'s list) as a ``('dp', 'mp')`` grid; ``dp`` -1
    takes as many as there are. With ``mp`` 1 the mesh is the 'dp' list of
    PR-22's sharded search."""
    devices = list(devices if devices is not None else default_devices())
    if dp == -1:
        dp = len(devices) // mp
    if mp == 1:
        return _grid(devices, (dp,), ("dp",))
    return _grid(devices, (dp, mp), ("dp", "mp"))


def get_pp_mesh(pp: int, dp: int = -1, devices=None) -> Mesh:
    """The ``('pp', 'dp')`` mesh of pipeline-parallel training
    (parallel/pipeline.py): stage s of 'dp' column d on device s * dp + d,
    as the reference's ``reshape(pp, dp)``."""
    devices = list(devices if devices is not None else default_devices())
    if dp == -1:
        dp = len(devices) // pp
    return _grid(devices, (pp, dp), ("pp", "dp"))


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
