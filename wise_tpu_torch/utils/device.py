"""Where the port's entry points run: the card, unless the caller asks for
the CPU."""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "WISE_TORCH_DEVICE"


def default_device() -> torch.device:
    """``$WISE_TORCH_DEVICE`` (``cpu``, ``cuda``, ``cuda:N``) when set, else
    the first CUDA card. Without a card and without the variable this
    raises: nothing falls back to the CPU on its own."""
    asked = os.environ.get(DEVICE_ENV, "").strip()
    if asked:
        device = torch.device(asked)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"{DEVICE_ENV}={asked!r}: expected cpu, cuda or "
                             "cuda:N")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{DEVICE_ENV}={asked} but "
                               "torch.cuda.is_available() is False")
        return device
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "no CUDA device is available (torch.cuda.is_available() is False); "
        f"set {DEVICE_ENV}=cpu to run on the CPU, or pass device= explicitly")
