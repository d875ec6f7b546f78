"""Weights into the port's CLAP.

``from_flax_params`` (shared with the CLIP port) carries the reference's
parameter tree (numpy arrays, as ``CLAP.init`` or wise_tpu's converter
produce it) onto the port's state_dict: the keys are the flax paths joined
by dots. ``load_checkpoint`` reads a staged msclap torch checkpoint
(``.pth`` / ``.pt``) through the reference's numpy converter.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch

from ..._host import clap_convert
from ..clip.convert import from_flax_params

__all__ = ["from_flax_params", "load_checkpoint", "load_msclap_state_dict"]


def load_msclap_state_dict(sd, config) -> Dict[str, torch.Tensor]:
    """msclap state dict (tensors or arrays, msclap key names) -> the
    port's state_dict."""
    sd = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    return from_flax_params(clap_convert.convert_msclap_state_dict(sd,
                                                                   config))


def load_checkpoint(path, config) -> Dict[str, torch.Tensor]:
    path = Path(path)
    if path.suffix not in (".pth", ".pt"):
        raise NotImplementedError(
            f"{path}: a flax-serialized CLAP checkpoint needs flax to read; "
            "the port reads msclap .pth/.pt checkpoints (ROADMAP Queue A "
            "item 9, open part)")
    raw = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model" in raw:
        raw = raw["model"]
    return load_msclap_state_dict(raw, config)
