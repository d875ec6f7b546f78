"""On-device CLIP image preprocessing (wise_tpu/models/clip/preprocess.py).

uint8 frames (B, H, W, 3) -> central square crop -> antialiased bicubic
resize to the model size -> [0, 1] -> channel normalise. The resize is
linear per axis, so it runs as two GEMMs with the exact separable weights of
jax.image's antialiased Keys-cubic resize (``resize_weights``); the operands
are bf16 and the sums f32, as in the reference's ``preprocess_images_gemm``.
Plain torch ops: the reference leaves this to XLA, not to a Pallas kernel.

``preprocess_images_exact`` is the host-side PIL path behind
``WISE_PREPROCESS=exact``, a copy of the reference's function
(wise_tpu/models/clip/preprocess.py:120).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def _triangle(x):
    return np.maximum(0.0, 1.0 - x).astype(np.float32)


#: jax.image.resize's kernels by method name
_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


@functools.lru_cache(maxsize=16)
def resize_weights(src: int, dst: int, method: str = "cubic") -> np.ndarray:
    """(dst, src) weights W with out = W @ in along one axis: the
    antialiased resize of jax.image.resize with ``method``'s kernel (Keys
    cubic, or the triangle of "linear"; scale dst / src, translation 0; the
    kernel widens by src / dst when downsampling), computed in f32 in the
    same order as jax's ``compute_weight_mat``."""
    f32 = np.float32
    inv = 1.0 / (dst / src)
    kernel_scale = f32(max(inv, 1.0))
    sample = (np.arange(dst, dtype=f32) + f32(0.5)) * f32(inv) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(src, dtype=f32)[:, None])
    w = _KERNELS[method](x / kernel_scale)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= f32(src) - f32(0.5))
    return np.ascontiguousarray(np.where(inside[None, :], w, 0.0).T,
                                dtype=f32)


def _normalise(x, mean, std):
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def _crop(frames):
    _, h, w, _ = frames.shape
    square = min(h, w)
    top, left = (h - square) // 2, (w - square) // 2
    return frames[:, top:top + square, left:left + square]


def preprocess_images(frames, target_size: int = 224,
                      mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD):
    """f32 path: frames (B, H, W, 3) uint8 -> (B, S, S, 3) f32 normalised,
    resize weights in f32."""
    x = _crop(frames).float() / 255.0
    if x.shape[1] != target_size:
        w = torch.from_numpy(resize_weights(x.shape[1], target_size)).to(
            x.device)
        x = torch.einsum("Hh,bhwc->bHwc", w, x)
        x = torch.einsum("wW,bHwc->bHWc", w.T, x)
    return _normalise(x, mean, std)


def preprocess_images_gemm(frames, target_size: int = 224,
                           mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD):
    """bf16-operand path of the production bf16 towers: pixels / 255 and
    the resize weights round to bf16, the two resize GEMMs sum in f32, the
    intermediate rounds to bf16 (reference preprocess_images_gemm)."""
    x = _crop(frames)
    if x.shape[1] == target_size:
        return preprocess_images(frames, target_size, mean, std)
    x = x.to(torch.bfloat16) / 255.0
    w = torch.from_numpy(resize_weights(x.shape[1], target_size)).to(
        device=x.device, dtype=torch.bfloat16).float()
    # bf16 values are exact in f32, so f32 GEMMs of them are bf16-operand
    # products with f32 sums
    x = torch.einsum("Hh,bhwc->bHwc", w, x.float()).to(torch.bfloat16)
    x = torch.einsum("wW,bHwc->bHWc", w.T, x.float())
    return _normalise(x, mean, std)


def preprocess_images_exact(frames: np.ndarray, target_size: int = 224,
                            mean=OPENAI_DATASET_MEAN,
                            std=OPENAI_DATASET_STD) -> np.ndarray:
    """Bit-faithful replica of the upstream preprocessing (open_clip's
    ``image_transform``): PIL shortest-side bicubic resize (PIL's resample is
    the antialiased convolution torchvision delegates to on PIL inputs) ->
    torchvision-style centre crop -> ToTensor -> Normalize. uint8 (B, H, W,
    3) or (H, W, 3) -> (B, S, S, 3) f32 on the host.

    Host-side and per frame: for parity audits and query-image embedding
    (``WISE_PREPROCESS=exact``), not for ingest throughput; the device path
    (``preprocess_images*``, crop first) is the production route. A copy of
    wise_tpu/models/clip/preprocess.py ``preprocess_images_exact``."""
    from PIL import Image

    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[None]
    s = target_size
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    out = np.empty((len(frames), s, s, 3), np.float32)
    for i, f in enumerate(frames):
        im = Image.fromarray(np.ascontiguousarray(f))
        w, h = im.size
        if (w, h) != (s, s):
            if w <= h:  # torchvision Resize(int): short side -> s
                new_w, new_h = s, int(s * h / w)
            else:
                new_w, new_h = int(s * w / h), s
            im = im.resize((new_w, new_h), Image.BICUBIC)
            arr = np.asarray(im, dtype=np.float32)
            top = int(round((new_h - s) / 2.0))
            left = int(round((new_w - s) / 2.0))
            arr = arr[top:top + s, left:left + s]
        else:
            arr = np.asarray(im, dtype=np.float32)
        out[i] = (arr / 255.0 - mean_a) / std_a
    return out
