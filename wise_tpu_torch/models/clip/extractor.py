"""OpenCLIP-compatible feature extractor on the port's CLIP towers
(wise_tpu/models/clip/extractor.py).

Same 4-token id scheme (``mlfoundations/open_clip/<model>/<pretrained>``),
same checkpoint search (``open_clip_*.{npz,pt,bin,safetensors}`` under
``$WISE_CHECKPOINT_DIR/<model>/<pretrained>/``, a
``bpe_simple_vocab_16e6.txt.gz`` beside it for real tokenisation), same
L2-normalised float32 outputs and batch buckets. Without a checkpoint the
towers take seeded random weights, with a warning. Frames move to the
device as uint8; preprocessing and both towers run there.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ...utils.device import default_device
from ..feature_extractor import BucketPolicy, DeviceArray, FeatureExtractor
from .config import production_clip_config
from .convert import load_checkpoint
from .model import CLIP, init_random_
from .tokenizer import get_tokenizer
from .preprocess import preprocess_images, preprocess_images_gemm

logger = logging.getLogger(__name__)


def _checkpoint_dir(model: str, pretrained: str) -> Path:
    root = os.environ.get(
        "WISE_CHECKPOINT_DIR",
        str(Path.home() / ".cache" / "wise_tpu" / "checkpoints"),
    )
    return Path(root) / model / pretrained


def _find_checkpoint(d: Path) -> Optional[Path]:
    if not d.exists():
        return None
    for pat in ("*.npz", "*.pt", "*.bin", "*.safetensors"):
        hits = sorted(d.glob(pat))
        if hits:
            return hits[0]
    return None


class OpenClipExtractor(FeatureExtractor):
    supports_audio = False

    def __init__(self, id: str, device=None):
        tok = id.split("/")
        if len(tok) != 4 or not id.startswith("mlfoundations/open_clip/"):
            raise ValueError(f"invalid open_clip extractor id {id}")
        self.id = id
        self.model_name, self.pretrained = tok[2], tok[3]
        self.device = torch.device(device) if device else default_device()
        self.config = production_clip_config(self.model_name)
        self.output_dim = self.config.embed_dim
        self.input_size = (self.config.image_size, self.config.image_size)

        model = CLIP(self.config)
        ckpt_dir = _checkpoint_dir(self.model_name, self.pretrained)
        ckpt = _find_checkpoint(ckpt_dir)
        if ckpt is None and ckpt_dir.exists() and any(ckpt_dir.glob("step_*")):
            raise NotImplementedError(
                f"{ckpt_dir} holds an orbax fine-tuned checkpoint; the port "
                "reads open_clip checkpoints only (ROADMAP Queue A item 13)")
        if ckpt is not None:
            logger.info(f"loading CLIP checkpoint {ckpt}")
            model.load_state_dict(load_checkpoint(ckpt, self.config))
        else:
            logger.warning(
                f"no checkpoint for {id} under {ckpt_dir}; using random "
                "weights (pipeline runs, retrieval quality needs real weights)"
            )
            init_random_(model, seed=0)
        self.model = model.to(self.device).eval().requires_grad_(False)

        bpe = ckpt_dir / "bpe_simple_vocab_16e6.txt.gz"
        self.tokenizer = get_tokenizer(
            bpe if bpe.exists() else None,
            vocab_size=self.config.vocab_size,
            context_length=self.config.context_length,
        )
        use_gemm = (self.config.dtype == "bfloat16"
                    and os.environ.get("WISE_PREPROCESS_GEMM", "1") == "1")
        #: uint8 (B, H, W, 3) device tensor -> normalised f32 model input
        self.preprocess_frames = (preprocess_images_gemm if use_gemm
                                  else preprocess_images)
        self._image_buckets = BucketPolicy()
        self._text_buckets = BucketPolicy()

    # ------------------------------------------------------------------
    def preprocess_image(self, images) -> np.ndarray:
        """Host-side canonicalisation: centre-crop to square and resize to
        the model size as uint8 (cv2 INTER_AREA down, INTER_CUBIC up), so the
        device sees one input shape whatever the source resolution."""
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = images[None]
        s = self.config.image_size
        out = []
        for im in images:
            im = np.asarray(im)
            h, w = im.shape[:2]
            if (h, w) != (s, s):
                import cv2

                square = min(h, w)
                top, left = (h - square) // 2, (w - square) // 2
                im = im[top:top + square, left:left + square]
                interp = cv2.INTER_AREA if square > s else cv2.INTER_CUBIC
                im = cv2.resize(im, (s, s), interpolation=interp)
            out.append(im)
        return np.stack(out)

    @staticmethod
    def _pad(arr: np.ndarray, m: int) -> np.ndarray:
        if m == arr.shape[0]:
            return arr
        return np.concatenate(
            [arr, np.zeros((m - arr.shape[0],) + arr.shape[1:], arr.dtype)])

    @torch.inference_mode()
    def extract_image_features_dispatch(self, images) -> DeviceArray:
        """Device half of ``extract_image_features``: the (n, D) embedding
        stays on the device until numpy reads it."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        s = self.config.image_size
        if images.shape[1:3] != (s, s):
            images = self.preprocess_image(images)
        n = images.shape[0]
        batch = self._pad(images, self._image_buckets.pick(n))
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        if x.dtype == torch.uint8:
            x = self.preprocess_frames(x, s)
        return DeviceArray(self.model.encode_image(x.float())[:n])

    def extract_image_features(self, images) -> np.ndarray:
        return np.asarray(self.extract_image_features_dispatch(images),
                          dtype=np.float32)

    @torch.inference_mode()
    def extract_text_features_dispatch(self, text_query: List[str]):
        tokens = self.tokenizer(list(text_query))
        n = tokens.shape[0]
        m = self._text_buckets.pick(n)
        if m != n:
            pad = np.full((m - n, tokens.shape[1]),
                          getattr(self.tokenizer, "pad_id", 0),
                          dtype=tokens.dtype)
            pad[:, 0] = getattr(self.tokenizer, "eot", 0)
            tokens = np.concatenate([tokens, pad])
        t = torch.from_numpy(tokens.astype(np.int64)).to(self.device)
        return DeviceArray(self.model.encode_text(t)[:n])

    def extract_text_features(self, text_query: List[str]) -> np.ndarray:
        return np.asarray(self.extract_text_features_dispatch(text_query),
                          dtype=np.float32)
