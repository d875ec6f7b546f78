"""OpenCLIP/torch checkpoint -> the port's CLIP state_dict.

Maps open_clip's CLIP state-dict naming (the checkpoints the reference loads
through open_clip.create_model_and_transforms,
src/feature/mlfoundation_openclip.py:38) onto the reference's parameter tree
as numpy arrays: pure numpy transposes, no torch ops beyond deserialise.
A SigLIP checkpoint (timm trunk under ``visual.trunk``) goes through
``convert_siglip_state_dict`` into the MAP-pooled tree. ``from_flax_params``
is the one function that carries such a tree (from the converters here, or
from the JAX package's ``CLIP.init``, SigLIP's included) onto the port's
state_dict: the port's keys are the flax paths joined by dots, so the map is
a flatten. ``load_openclip_state_dict`` and ``load_checkpoint`` end in it.

Copy of ``wise_tpu/models/clip/convert.py``, with ``from_flax_params``
added.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def from_flax_params(tree) -> Dict[str, torch.Tensor]:
    """{'params': {...}} or the inner tree -> {state_dict key: f32 tensor}.
    The XLM-R tower's separate ``self/{query, key, value}`` projections
    become the one ``qkv`` Dense (D, 3D) the port stores."""
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
    for q_key in [k for k in out if ".self.query." in k]:
        parts = [out.pop(q_key.replace(".self.query.", f".self.{name}."))
                 for name in ("query", "key", "value")]
        out[q_key.replace(".self.query.", ".qkv.")] = torch.cat(parts, dim=-1)
    return out


def _ln(sd, prefix):
    return {
        "scale": np.asarray(sd[prefix + ".weight"], dtype=np.float32),
        "bias": np.asarray(sd[prefix + ".bias"], dtype=np.float32),
    }


def _dense(sd, prefix):
    return {
        "kernel": np.asarray(sd[prefix + ".weight"], dtype=np.float32).T,
        "bias": np.asarray(sd[prefix + ".bias"], dtype=np.float32),
    }


def _resblock(sd, prefix):
    return {
        "ln_1": _ln(sd, prefix + ".ln_1"),
        "ln_2": _ln(sd, prefix + ".ln_2"),
        "attn": {
            "in_proj": {
                "kernel": np.asarray(
                    sd[prefix + ".attn.in_proj_weight"], dtype=np.float32
                ).T,
                "bias": np.asarray(
                    sd[prefix + ".attn.in_proj_bias"], dtype=np.float32
                ),
            },
            "out_proj": _dense(sd, prefix + ".attn.out_proj"),
        },
        "mlp_fc": _dense(sd, prefix + ".mlp.c_fc"),
        "mlp_proj": _dense(sd, prefix + ".mlp.c_proj"),
    }


def _transformer(sd, prefix, layers):
    return {
        f"resblocks_{i}": _resblock(sd, f"{prefix}.resblocks.{i}")
        for i in range(layers)
    }


def _timm_block(sd, prefix):
    """timm ViT block (SigLIP vision trunk) -> our resblock tree."""
    return {
        "ln_1": _ln(sd, prefix + ".norm1"),
        "ln_2": _ln(sd, prefix + ".norm2"),
        "attn": {
            "in_proj": _dense(sd, prefix + ".attn.qkv"),
            "out_proj": _dense(sd, prefix + ".attn.proj"),
        },
        "mlp_fc": _dense(sd, prefix + ".mlp.fc1"),
        "mlp_proj": _dense(sd, prefix + ".mlp.fc2"),
    }


def convert_siglip_state_dict(sd: Dict[str, np.ndarray], config) -> Dict:
    """open_clip SigLIP checkpoint (timm vision trunk under ``visual.trunk``,
    open_clip TextTransformer under ``text``) -> our CLIP params tree with
    vision_pool='map'. Architecture parity vs transformers-Siglip is pinned
    by tests/test_siglip_torch_parity.py."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    vt = "visual.trunk"
    width = config.vision_width
    pos = np.asarray(sd[f"{vt}.pos_embed"], dtype=np.float32)
    if pos.ndim == 3:
        pos = pos[0]
    ap = f"{vt}.attn_pool"
    qk = np.asarray(sd[f"{ap}.q.weight"], np.float32).T        # (D, D)
    qb = np.asarray(sd[f"{ap}.q.bias"], np.float32)
    kvk = np.asarray(sd[f"{ap}.kv.weight"], np.float32).T      # (D, 2D)
    kvb = np.asarray(sd[f"{ap}.kv.bias"], np.float32)
    latent = np.asarray(sd[f"{ap}.latent"], np.float32)
    if latent.ndim == 3:
        latent = latent[0]
    visual = {
        "conv1": {
            "kernel": np.transpose(
                np.asarray(sd[f"{vt}.patch_embed.proj.weight"], np.float32),
                (2, 3, 1, 0),
            ),
            "bias": np.asarray(
                sd[f"{vt}.patch_embed.proj.bias"], np.float32
            ),
        },
        "positional_embedding": pos,
        "transformer": {
            f"resblocks_{i}": _timm_block(sd, f"{vt}.blocks.{i}")
            for i in range(config.vision_layers)
        },
        "ln_post": _ln(sd, f"{vt}.norm"),
        "attn_pool": {
            "probe": latent,
            "q_proj": {"kernel": qk, "bias": qb},
            "kv_proj": {"kernel": kvk, "bias": kvb},
            "out_proj": _dense(sd, f"{ap}.proj")
            if f"{ap}.proj.weight" in sd
            else _dense(sd, f"{ap}.proj_drop"),  # naming variants
            "norm": _ln(sd, f"{ap}.norm"),
            "mlp_fc": _dense(sd, f"{ap}.mlp.fc1"),
            "mlp_proj": _dense(sd, f"{ap}.mlp.fc2"),
        },
        # SigLIP has no separate visual projection; ours stays identity
        "proj": np.eye(width, config.embed_dim, dtype=np.float32),
    }
    text = {
        "token_embedding": np.asarray(
            sd["text.token_embedding.weight"], np.float32
        ),
        "positional_embedding": np.asarray(
            sd["text.positional_embedding"], np.float32
        ),
        "transformer": {
            f"resblocks_{i}": _resblock(sd, f"text.transformer.resblocks.{i}")
            for i in range(config.text_layers)
        },
        "ln_final": _ln(sd, "text.ln_final"),
        "text_projection": np.asarray(
            sd["text.text_projection.weight"], np.float32
        ).T,
        "text_projection_bias": np.asarray(
            sd["text.text_projection.bias"], np.float32
        ),
    }
    return {
        "visual": visual,
        "text": text,
        "logit_scale": np.asarray(sd["logit_scale"], np.float32),
    }


def convert_openclip_state_dict(sd: Dict[str, np.ndarray], config) -> Dict:
    """sd: flat torch-style state dict (tensors or ndarrays). Returns a flax
    params tree for the reference's CLIP (numpy arrays)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    if getattr(config, "vision_pool", "cls") == "map":
        return convert_siglip_state_dict(sd, config)
    if getattr(config, "text_tower", "clip") == "hf_xlm_roberta":
        from .hf_text import convert_hf_text_state_dict, hf_text_config

        text_params = convert_hf_text_state_dict(sd, hf_text_config(config))
    else:
        text_params = None
    params = {
        "visual": {
            "conv1": {
                # torch conv weight (out, in, kh, kw) -> flax (kh, kw, in, out)
                "kernel": np.transpose(
                    np.asarray(sd["visual.conv1.weight"], dtype=np.float32),
                    (2, 3, 1, 0),
                )
            },
            "class_embedding": np.asarray(
                sd["visual.class_embedding"], dtype=np.float32
            ),
            "positional_embedding": np.asarray(
                sd["visual.positional_embedding"], dtype=np.float32
            ),
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "transformer": _transformer(
                sd, "visual.transformer", config.vision_layers
            ),
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": np.asarray(sd["visual.proj"], dtype=np.float32),
        },
        "text": text_params
        if text_params is not None
        else {
            "token_embedding": np.asarray(
                sd["token_embedding.weight"], dtype=np.float32
            ),
            "positional_embedding": np.asarray(
                sd["positional_embedding"], dtype=np.float32
            ),
            "transformer": _transformer(sd, "transformer", config.text_layers),
            "ln_final": _ln(sd, "ln_final"),
            "text_projection": np.asarray(
                sd["text_projection"], dtype=np.float32
            ),
        },
        "logit_scale": np.asarray(sd["logit_scale"], dtype=np.float32),
    }
    return params


def _tensor_np(v):
    """torch tensor / ndarray -> ndarray; upcasts bf16 (``.numpy()`` raises
    on torch bf16 tensors, and several published checkpoints ship bf16)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        if str(v.dtype) == "torch.bfloat16":
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def convert_checkpoint_file(src, dst) -> int:
    """Re-serialise a torch .pt/.bin checkpoint as .npz (torch key names
    preserved), so runtime loads need numpy only. Returns tensor count."""
    raw = torch.load(str(src), map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    sd = {k.replace("module.", ""): _tensor_np(v) for k, v in raw.items()}
    np.savez(str(dst), **sd)
    return len(sd)


_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": None,  # handled specially below
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def load_safetensors(path) -> Dict[str, np.ndarray]:
    """Minimal dependency-free safetensors reader: u64 header length +
    JSON header {name: {dtype, shape, data_offsets}} + raw little-endian
    tensor bytes."""
    import json

    with open(path, "rb") as f:
        (header_len,) = np.frombuffer(f.read(8), dtype="<u8")
        header = json.loads(f.read(int(header_len)).decode("utf-8"))
        data = f.read()
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        start, end = spec["data_offsets"]
        raw = data[start:end]
        shape = tuple(spec["shape"])
        if spec["dtype"] == "BF16":
            u16 = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = u16.view(np.float32).astype(np.float32)
        else:
            arr = np.frombuffer(
                raw, dtype=np.dtype(_SAFETENSORS_DTYPES[spec["dtype"]]).newbyteorder("<")
            )
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
        out[name] = arr.reshape(shape)
    return out


def _check_mlp_width(sd, config) -> None:
    """Refuse an open_clip checkpoint whose MLP is not 4 x the tower's
    width, the only MLP the registry's configs (the reference's) build. The
    published ViT-g-14 and ViT-bigG-14 checkpoints have 6,144- and
    8,192-wide MLPs against the registry's 5,632 and 6,656 (ROADMAP Queue C
    11): say so here rather than fail later on a shape."""
    towers = (("visual.transformer", config.vision_width, "vision"),
              ("transformer", config.text_width, "text"))
    for prefix, width, tower in towers:
        w = sd.get(f"{prefix}.resblocks.0.mlp.c_fc.weight")
        if w is None:
            continue
        inner = int(np.shape(w)[0])
        if inner != 4 * width:
            raise ValueError(
                f"checkpoint's {tower} MLP is {inner} wide; the config builds "
                f"4 x {width} = {4 * width}, as the reference's registry "
                f"does. The published open_clip ViT-g-14 and ViT-bigG-14 "
                f"checkpoints have wider MLPs than the registry's entries of "
                f"those names and load into neither package (ROADMAP Queue "
                f"C 11)")


def load_openclip_state_dict(sd, config) -> Dict[str, torch.Tensor]:
    """open_clip state dict (tensors or arrays, open_clip key names) ->
    the port's state_dict. A checkpoint whose MLP is not 4 x the tower's
    width raises (:func:`_check_mlp_width`)."""
    if getattr(config, "vision_pool", "cls") != "map":
        _check_mlp_width(sd, config)
    return from_flax_params(convert_openclip_state_dict(sd, config))


def load_checkpoint(path, config) -> Dict[str, torch.Tensor]:
    """Load a .pt/.bin (torch), .safetensors, or .npz checkpoint into the
    port's state_dict."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
    elif path.endswith(".safetensors"):
        sd = load_safetensors(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and "state_dict" in raw:
            raw = raw["state_dict"]
        sd = {k.replace("module.", ""): _tensor_np(v) for k, v in raw.items()}
    return load_openclip_state_dict(sd, config)


if __name__ == "__main__":
    import sys

    if len(sys.argv) != 3:
        print("usage: python -m wise_tpu_torch.models.clip.convert IN.pt OUT.npz")
        raise SystemExit(1)
    n = convert_checkpoint_file(sys.argv[1], sys.argv[2])
    print(f"converted {n} tensors -> {sys.argv[2]}")
