"""Weights into the port's CLIP.

``from_flax_params`` carries the reference's parameter tree (numpy arrays,
as ``CLIP.init`` or wise_tpu's converter produce it) onto the port's
state_dict: the port's keys are the flax paths joined by dots, so the map is
a flatten. ``load_openclip_state_dict`` and ``load_checkpoint`` read
published OpenCLIP weights (.npz, .pt, .bin, .safetensors) through the
reference's numpy converter.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..._host import clip_convert


def from_flax_params(tree) -> Dict[str, torch.Tensor]:
    """{'params': {...}} or the inner tree -> {state_dict key: f32 tensor}."""
    tree = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, path + [re.sub(r"^resblocks_(\d+)$", r"resblocks.\1",
                                       str(k))])
        else:
            out[".".join(path)] = torch.from_numpy(
                np.array(node, dtype=np.float32))

    walk(tree, [])
    return out


def load_openclip_state_dict(sd, config) -> Dict[str, torch.Tensor]:
    """open_clip state dict (tensors or arrays, open_clip key names) ->
    the port's state_dict."""
    return from_flax_params(clip_convert.convert_openclip_state_dict(sd,
                                                                     config))


def load_checkpoint(path, config) -> Dict[str, torch.Tensor]:
    return from_flax_params(clip_convert.load_checkpoint(path, config))
