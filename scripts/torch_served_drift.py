"""How far the port's kernel path drifts from its plain PyTorch path on the
scores `chip_smoke.py`'s ViT-B/32 slice serves, on one CUDA GPU.

The slice phase of `chip_smoke.py` holds every served top-10 score to the
plain path's within 1e-3 (plus the response's 3-decimal rounding). This
script embeds the same 4,096 seeded frames and 8 queries through both paths
(OpenCLIP ViT-B/32, production config, random weights from seed 0) and
prints, as one JSON line, the largest deviation over each query's plain
top-10, split into the image side (kernel image embeddings, plain query) and
the text side (plain image embeddings, kernel query), with the least
per-row cosine of each tower's embeddings. A change to a kernel's rounding
moves these numbers; the slice's check sees them after rounding.

    python3 scripts/torch_served_drift.py [tag]

Imports torch and the port only (through `chip_smoke.py`'s helpers).
"""

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


def _min_cos(a, b) -> float:
    return float(((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
                  / np.linalg.norm(b, axis=-1)).min())


def main(tag: str = "") -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("torch_served_drift: needs a CUDA device")
    t0 = time.perf_counter()
    fe = OpenClipExtractor(cs.MODEL_ID)
    clips = [cs._frames(s, 256, 224) for s in range(cs.FRAMES // 256)]
    prefix = SearchConfig().query_prefix
    with torch.inference_mode():
        kv = np.concatenate([fe.extract_image_features(c) for c in clips])
        plain = cs._twin(torch, fe)
        pv = np.concatenate([plain.extract_image_features(c) for c in clips])
        kq = np.stack([fe.extract_text_features([f"{prefix} {q}"])[0]
                       for q in cs.QUERIES])
        pq = np.stack([plain.extract_text_features([f"{prefix} {q}"])[0]
                       for q in cs.QUERIES])
    top10, image_side, text_side = [], [], []
    for k_q, p_q in zip(kq, pq):
        ps = pv @ p_q
        top = np.argsort(-ps)[:10]
        top10.append(float(np.abs(kv[top] @ k_q - ps[top]).max()))
        image_side.append(float(np.abs(kv[top] @ p_q - ps[top]).max()))
        text_side.append(float(np.abs(pv[top] @ k_q - ps[top]).max()))
    out = dict(tag=tag, device=torch.cuda.get_device_name(0),
               img_min_cos=_min_cos(kv, pv), text_min_cos=_min_cos(kq, pq),
               top10_max_dev=top10, img_side=max(image_side),
               txt_side=max(text_side),
               seconds=round(time.perf_counter() - t0, 1))
    print("[drift] " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
