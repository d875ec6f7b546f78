"""How far the port's served scores drift from the plain PyTorch path's, on
the CLIP slices of `chip_smoke.py`, on one CUDA GPU.

The slice phases of `chip_smoke.py` hold every served top-10 distance to a
plain run's score of the same vector within 1e-3, plus 5e-4 for the
response's 3-decimal rounding (`_check_against_plain`). This script embeds a
slice's seeded frames and 8 queries (the smoke's own, at the smoke's frame
counts and sizes) through three paths on the same weights: the kernel path
(the extractor, production config), the plain bf16 path (`_twin`: both
kernel switches off) and the plain path in float32 (each bf16 weight is
exact in f32; TF32 off). For each query it takes the kernel path's top-10,
as the server would return them, and prints as one JSON line a slice:

- ``gap_vs_plain`` / ``gap_vs_f32``: the largest |round(kernel score, 3) -
  reference score| over the 8 queries' top-10, what the smoke's check
  compares with its 0.0015 bar, against the bf16 and the f32 plain path;
- ``dev_vs_plain`` / ``dev_vs_f32``: the same, unrounded;
- ``{kernel,plain}_{img,txt}_1-cos_vs_f32``: each bf16 path's mean and
  largest 1 - cosine to float32 over the slice's image embeddings and 256
  text embeddings (the 8 queries, 32 numbered variants each): which of the
  two bf16 paths is the more exact.

Each slice runs twice: on the weights the extractor draws (seed 0 on the
host) and on seed 0 drawn by the card's generator (``init_random_`` on a
model built on the card), whose numbers differ.

    python3 scripts/torch_served_drift.py [--slices slice,vit_h,...] [tag]

``--slices`` takes any of slice (ViT-B/32, 4,096 frames), siglip, vit_h,
vit_g, vit_bigg, xlmr; the default is slice. Imports torch and the port
only (through `chip_smoke.py`'s helpers).
"""

import argparse
import copy
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from wise_tpu_torch.config import SearchConfig  # noqa: E402
from wise_tpu_torch.models.clip.extractor import OpenClipExtractor  # noqa: E402
from wise_tpu_torch.models.clip.model import CLIP, init_random_  # noqa: E402

#: the smoke's CLIP slices: (model id, frames, frame size)
SLICES = {"slice": (cs.MODEL_ID, cs.FRAMES, 224),
          "siglip": (cs.SIGLIP_ID, cs.SIGLIP_FRAMES, 384),
          "vit_h": (cs.VIT_H_ID, cs.VIT_H_FRAMES, 224),
          "vit_g": (cs.VIT_G_ID, cs.WIDE_FRAMES, 224),
          "vit_bigg": (cs.VIT_BIGG_ID, cs.WIDE_FRAMES, 224),
          "xlmr": (cs.XLMR_ID, cs.XLMR_FRAMES, 224)}


def _f32_twin(fe):
    """The plain path in float32 on the extractor's weights."""
    with torch.device(fe.device):
        model = CLIP(dataclasses.replace(fe.config, dtype="float32",
                                         fused_block=False,
                                         fused_attention=False))
    model.load_state_dict(fe.model.state_dict())
    twin = copy.copy(fe)
    twin.config = model.config
    twin.model = model.eval().requires_grad_(False)
    return twin


def _cos_err(a, b) -> list:
    c = ((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
         / np.linalg.norm(b, axis=-1))
    return [float((1 - c).mean()), float((1 - c).max())]


def _measure(fe, clips, queries, variants) -> dict:
    """The kernel path's served top-10 scores against the plain bf16 and
    f32 paths', and each bf16 path's embeddings against f32's."""
    paths = {"kernel": fe, "plain": cs._twin(torch, fe), "f32": _f32_twin(fe)}
    img, txt, many = {}, {}, {}
    with torch.inference_mode():
        for name, p in paths.items():
            img[name] = np.concatenate([p.extract_image_features(c[i:i + 256])
                                        for c in clips
                                        for i in range(0, len(c), 256)])
            txt[name] = np.stack([p.extract_text_features([q])[0]
                                  for q in queries])
            many[name] = np.concatenate([
                p.extract_text_features(variants[i:i + 64])
                for i in range(0, len(variants), 64)])
    del paths
    scores = {n: img[n] @ txt[n].T for n in img}     # (rows, queries)
    out = {}
    for ref in ("plain", "f32"):
        gap, dev = 0.0, 0.0
        for j in range(len(queries)):
            top = np.argsort(-scores["kernel"][:, j])[:10]
            k = scores["kernel"][top, j]
            gap = max(gap, float(np.abs(np.round(k, 3)
                                        - scores[ref][top, j]).max()))
            dev = max(dev, float(np.abs(k - scores[ref][top, j]).max()))
        out[f"gap_vs_{ref}"], out[f"dev_vs_{ref}"] = gap, dev
    for n in ("kernel", "plain"):
        out[f"{n}_img_1-cos_vs_f32"] = _cos_err(img[n], img["f32"])
        out[f"{n}_txt_1-cos_vs_f32"] = _cos_err(many[n], many["f32"])
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slices", default="slice")
    ap.add_argument("tag", nargs="?", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_served_drift: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prefix = SearchConfig().query_prefix
    queries = [f"{prefix} {q}".strip() for q in cs.QUERIES]
    variants = [f"{q} {i}" for q in queries for i in range(32)]
    lines = []
    for name in args.slices.split(","):
        model_id, n_frames, size = SLICES[name]
        clips = [cs._frames(s, min(256, n_frames - s * 256), size)
                 for s in range((n_frames + 255) // 256)]
        fe = OpenClipExtractor(model_id)
        for weights in ("host", "card"):
            t0 = time.perf_counter()
            if weights == "card":
                with torch.device(fe.device):
                    drawn = init_random_(CLIP(fe.config), seed=0)
                fe.model.load_state_dict(drawn.state_dict())
                del drawn
            line = dict(tag=args.tag, slice=name,
                        model=model_id.split("/")[2], weights=weights,
                        frames=n_frames,
                        **_measure(fe, clips, queries, variants),
                        seconds=round(time.perf_counter() - t0, 1))
            print("[drift] " + json.dumps(line), flush=True)
            lines.append(line)
        del fe
        gc.collect()
        torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
