"""Where the port's entry points run: the card, unless the caller asks for
the CPU.

``$WISE_TORCH_DEVICE`` names one device (``cpu``, ``cuda``, ``cuda:N``) or,
comma-separated, the devices of a mesh (``cuda:0,cuda:1``, ``cpu,cpu,cpu,cpu``;
``parallel/mesh.py``). A device may be named more than once: on one card,
``cuda:0,cuda:0`` runs the sharded code as two shards on that card, as the
JAX package's tests force eight CPU devices.
"""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "WISE_TORCH_DEVICE"


def _parse(name: str) -> torch.device:
    device = torch.device(name)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{DEVICE_ENV}={name!r}: expected cpu, cuda or "
                         "cuda:N")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{DEVICE_ENV}={name} but "
                           "torch.cuda.is_available() is False")
    return device


def _mesh_list(asked: str) -> list:
    """The devices of a comma-separated ``asked``: one type, and every card
    one the machine has."""
    devices = [_parse(name.strip()) for name in asked.split(",")]
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"{DEVICE_ENV}={asked!r}: a mesh is of one device "
                         "type")
    if devices[0].type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", d.index or 0) for d in devices]
        missing = sorted({d.index for d in devices if d.index >= count})
        if missing:
            raise RuntimeError(f"{DEVICE_ENV}={asked}: no card "
                               f"{missing} on this machine ({count} visible)")
    return devices


def default_devices() -> list:
    """The mesh's devices, as ``jax.devices()`` gives the reference's:
    ``$WISE_TORCH_DEVICE`` when set (one device, or a comma-separated list),
    else every visible card. Without a card and without the variable this
    raises."""
    asked = os.environ.get(DEVICE_ENV, "").strip()
    if "," in asked:
        return _mesh_list(asked)
    if asked or not torch.cuda.device_count():
        return [default_device()]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def named_devices() -> list:
    """The devices that ``$WISE_TORCH_DEVICE`` names, one or a list, else
    ``[default_device()]``: what an index searches on. Its rows shard only
    over a list that is named, never over the machine's other cards on
    their own (a collection that fits on one card searches faster there,
    with no merge)."""
    asked = os.environ.get(DEVICE_ENV, "").strip()
    if "," in asked:
        return _mesh_list(asked)
    return [default_device()]


def default_device() -> torch.device:
    """``$WISE_TORCH_DEVICE`` (``cpu``, ``cuda``, ``cuda:N``, or a list whose
    first device this is) when set, else the first CUDA card. Without a
    card and without the variable this raises: nothing falls back to the
    CPU on its own."""
    asked = os.environ.get(DEVICE_ENV, "").strip()
    if "," in asked:
        return _mesh_list(asked)[0]
    if asked:
        return _parse(asked)
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "no CUDA device is available (torch.cuda.is_available() is False); "
        f"set {DEVICE_ENV}=cpu to run on the CPU, or pass device= explicitly")
