"""Seeded weights for a configuration, made on the device.

The benchmark makes the weights itself and hands the same tensors to the
program (through its state_dict loader) and to the plain reference. Names
and layouts are the port's state_dict keys (models/clip/model.py and
hf_text.py): every matrix is (in, out), a patch kernel (p, p, 3, D), a
packed in-projection (D, 3D) holds q, k, v in that order, head by head.

One ``torch.randn`` call on the device per dtype group draws every number;
each tensor is a slice of it, scaled by its family: lecun-normal matrices
(std 1 / sqrt(fan_in)), N(0, 0.02) embeddings, biases and probe,
LayerNorm scales 1 + N(0, 0.02) and biases N(0, 0.02). Non-zero biases and
scales keep a dropped bias or LayerNorm from passing unseen.
"""

from __future__ import annotations

import math

import torch


def _ln(prefix):
    return [(prefix + ".scale", None, "ln_scale"),
            (prefix + ".bias", None, "ln_bias")]


def _dense(prefix, din, dout):
    return [(prefix + ".kernel", (din, dout), "kernel"),
            (prefix + ".bias", (dout,), "bias")]


def vision_spec(v: dict, prefix: str = "visual."):
    """[(name, shape, family)] of a vision tower's parameters."""
    d, f, p = v["width"], v["mlp_width"], v["patch_size"]
    cls = v["pool"] == "cls"
    n_tok = (v["image_size"] // p) ** 2 + int(cls)
    out = [(prefix + "conv1.kernel", (p, p, 3, d), "kernel")]
    if not cls:
        out.append((prefix + "conv1.bias", (d,), "bias"))
    if cls:
        out.append((prefix + "class_embedding", (d,), "embed"))
    out.append((prefix + "positional_embedding", (n_tok, d), "embed"))
    if cls:
        out += _ln(prefix + "ln_pre")
    for i in range(v["layers"]):
        b = f"{prefix}transformer.resblocks.{i}."
        out += _ln(b + "ln_1") + _dense(b + "attn.in_proj", d, 3 * d)
        out += _dense(b + "attn.out_proj", d, d) + _ln(b + "ln_2")
        out += _dense(b + "mlp_fc", d, f) + _dense(b + "mlp_proj", f, d)
    out += _ln(prefix + "ln_post")
    if not cls:
        a = prefix + "attn_pool."
        out.append((a + "probe", (1, d), "embed"))
        out += _dense(a + "q_proj", d, d) + _dense(a + "kv_proj", d, 2 * d)
        out += _dense(a + "out_proj", d, d) + _ln(a + "norm")
        out += _dense(a + "mlp_fc", d, f) + _dense(a + "mlp_proj", f, d)
    family = "identity" if v.get("proj") == "identity" else "kernel"
    out.append((prefix + "proj", (d, v["embed_dim"]), family))
    return [(n, s if s is not None else (d,), fam) for n, s, fam in out]


def text_spec(t: dict, prefix: str = "text."):
    """[(name, shape, family)] of an XLM-R text tower's parameters."""
    if t["kind"] != "xlm_roberta" or t["proj"] != "mlp":
        raise ValueError(f"no weight layout for text tower {t['kind']!r} "
                         f"with a {t['proj']!r} head")
    d, f = t["width"], t["mlp_width"]
    out = [(prefix + "word_embeddings", (t["vocab_size"], d), "embed"),
           (prefix + "position_embeddings", (t["max_positions"], d),
            "embed")]
    out += _ln(prefix + "emb_ln")
    for i in range(t["layers"]):
        b = f"{prefix}layer_{i}."
        out += _dense(b + "qkv", d, 3 * d) + _dense(b + "attn_out", d, d)
        out += _ln(b + "attn_ln") + _dense(b + "intermediate", d, f)
        out += _dense(b + "output", f, d) + _ln(b + "out_ln")
    hidden = (d + t["embed_dim"]) // 2
    out += [(prefix + "proj_fc", (d, hidden), "kernel"),
            (prefix + "proj_out", (hidden, t["embed_dim"]), "kernel")]
    return [(n, s if s is not None else (d,), fam) for n, s, fam in out]


def served_dtype(name: str, family: str) -> torch.dtype:
    """The dtype the port serves a parameter in: LayerNorms and the XLM-R
    projection head f32, every other matrix, bias and table bf16."""
    if family.startswith("ln_") or name.startswith("text.proj_"):
        return torch.float32
    return torch.bfloat16


def make(spec, seed: int, device, dtype_of) -> dict:
    """{name: tensor} for ``spec``, drawn on ``device`` from ``seed``:
    one randn a dtype group (``dtype_of(name, family)``), in the spec's
    order, sliced and scaled in place."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    groups: dict = {}
    for name, shape, family in spec:
        groups.setdefault(dtype_of(name, family), []).append(
            (name, shape, family))
    out = {}
    for dtype in sorted(groups, key=str):
        entries = groups[dtype]
        total = sum(math.prod(s) for _, s, _ in entries)
        buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
        off = 0
        for name, shape, family in entries:
            n = math.prod(shape)
            t = buf[off:off + n].view(shape)
            off += n
            if family == "kernel":
                t.mul_(1.0 / math.sqrt(math.prod(shape[:-1])))
            elif family == "ln_scale":
                t.mul_(0.02).add_(1.0)
            elif family == "identity":
                t.copy_(torch.eye(*shape, dtype=dtype, device=device))
            else:
                t.mul_(0.02)
            out[name] = t
    return out


#: the port's packed in-projections, whose columns are the published
#: model's separate query, key and value leaves
_PACKED = ("attn.in_proj.kernel", "attn.in_proj.bias", ".qkv.kernel",
           ".qkv.bias")


def leaf_norms(tensors: dict, scale=1.0) -> dict:
    """{leaf: float norm} of ``tensors`` (port keys) times ``scale``, a
    packed in-projection split into the published model's query, key and
    value leaves (``<key>.q``, ``.k``, ``.v``): the key's bias, whose
    gradient is nought under softmax, is a leaf of its own there."""
    out = {}
    for name, t in tensors.items():
        t = t.detach().float()
        parts = (zip("qkv", t.chunk(3, dim=-1)) if name.endswith(_PACKED)
                 else [(None, t)])
        for tag, part in parts:
            key = name if tag is None else f"{name}.{tag}"
            out[key] = float(torch.linalg.vector_norm(part) * scale)
    return out


def logit_scale(device, dtype=torch.float32):
    """log(1 / 0.07), CLIP's initial temperature, as the port keeps it."""
    return torch.tensor(math.log(1 / 0.07), dtype=dtype, device=device)
