"""CLIP configurations, without JAX.

The fields and registry entries of wise_tpu/models/clip/model.py
(``CLIPConfig``, ``CLIP_CONFIGS``) with ``dtype`` as a name ("float32" or
"bfloat16") in place of a jnp dtype. The port builds the OpenCLIP towers
(class-token vision, causal argmax-pooled text), the SigLIP towers
(MAP-pooled vision, bidirectional last-token text) and the XLM-RoBERTa text
tower of the default backbone. The registry holds every entry of the
reference's, field for field. ViT-g-14 and ViT-bigG-14 keep the reference's
4 x width MLP (5,632 and 6,656), which the published open_clip checkpoints
of those names do not have (6,144 and 8,192): ``models/clip/convert.py``
refuses such a checkpoint (ROADMAP Queue C 11).
"""

from __future__ import annotations

import dataclasses
import os

import torch


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    quick_gelu: bool = False
    #: activation override: "" (use quick_gelu), "gelu", "quick_gelu",
    #: "gelu_tanh"
    act: str = ""
    text_proj_bias: bool = False
    text_tower: str = "clip"
    hf_proj_type: str = "linear"
    vision_pool: str = "cls"
    text_causal: bool = True
    text_pool: str = "argmax"
    remat: bool = False
    attn_softmax_f32: bool = True
    #: run the attention middle of a block through the attention kernel
    #: (ops/attention.py) where ``fused_block`` is off
    fused_attention: bool = False
    #: run residual blocks through the CUDA block kernels (ops/block.py)
    fused_block: bool = False
    #: the port always embeds patches as patchify + one GEMM
    patch_embed_matmul: bool = False
    #: the last layer computes only the pooled row (cls / EOT)
    pool_last_block: bool = False
    #: carry the vision residual stream in ``dtype`` instead of f32
    bf16_stream: bool = False
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.dtype]

    @property
    def act_name(self) -> str:
        if self.act:
            return self.act
        return "quick_gelu" if self.quick_gelu else "gelu"


CLIP_CONFIGS = {
    "ViT-B-32": CLIPConfig(),
    "ViT-B-16": CLIPConfig(patch_size=16),
    "ViT-L-14": CLIPConfig(
        embed_dim=768, patch_size=14, vision_width=1024, vision_layers=24,
        vision_heads=16, text_width=768, text_heads=12, text_layers=12,
    ),
    "ViT-H-14": CLIPConfig(
        embed_dim=1024, patch_size=14, vision_width=1280, vision_layers=32,
        vision_heads=16, text_width=1024, text_heads=16, text_layers=24,
    ),
    # the reference's default extractor backbone: ViT-H-14 vision +
    # XLM-RoBERTa-large text
    "xlm-roberta-large-ViT-H-14": CLIPConfig(
        embed_dim=1024, patch_size=14, vision_width=1280, vision_layers=32,
        vision_heads=16, context_length=64, vocab_size=250002,
        text_width=1024, text_heads=16, text_layers=24,
        text_tower="hf_xlm_roberta", hf_proj_type="mlp",
    ),
    "ViT-L-14-336": CLIPConfig(
        embed_dim=768, image_size=336, patch_size=14, vision_width=1024,
        vision_layers=24, vision_heads=16, text_width=768, text_heads=12,
        text_layers=12,
    ),
    # vision head_dim 88 and 104, text 64
    "ViT-g-14": CLIPConfig(
        embed_dim=1024, patch_size=14, vision_width=1408, vision_layers=40,
        vision_heads=16, text_width=1024, text_heads=16, text_layers=24,
    ),
    "ViT-bigG-14": CLIPConfig(
        embed_dim=1280, patch_size=14, vision_width=1664, vision_layers=48,
        vision_heads=16, text_width=1280, text_heads=20, text_layers=32,
    ),
    # SigLIP (upstream WISE's integration test runs ViT-L-16-SigLIP-384):
    # MAP-pooled vision, non-causal last-pooled text
    "ViT-L-16-SigLIP-384": CLIPConfig(
        embed_dim=1024, image_size=384, patch_size=16, vision_width=1024,
        vision_layers=24, vision_heads=16, context_length=64,
        vocab_size=32000, text_width=1024, text_heads=16, text_layers=12,
        vision_pool="map", text_causal=False, text_pool="last",
        act="gelu_tanh", text_proj_bias=True,
    ),
    "ViT-B-16-SigLIP-256": CLIPConfig(
        embed_dim=768, image_size=256, patch_size=16, vision_width=768,
        vision_layers=12, vision_heads=12, context_length=64,
        vocab_size=32000, text_width=768, text_heads=12, text_layers=12,
        vision_pool="map", text_causal=False, text_pool="last",
        act="gelu_tanh", text_proj_bias=True,
    ),
    "ViT-Test-Tiny": CLIPConfig(
        embed_dim=32, image_size=32, patch_size=16, vision_width=64,
        vision_layers=2, vision_heads=4, context_length=16,
        vocab_size=1024, text_width=32, text_heads=4, text_layers=2,
    ),
    "ViT-B-32-quickgelu": CLIPConfig(quick_gelu=True),
    "ViT-B-16-quickgelu": CLIPConfig(patch_size=16, quick_gelu=True),
    "ViT-L-14-quickgelu": CLIPConfig(
        embed_dim=768, patch_size=14, vision_width=1024, vision_layers=24,
        vision_heads=16, text_width=768, text_heads=12, text_layers=12,
        quick_gelu=True,
    ),
    "ViT-H-14-quickgelu": CLIPConfig(
        embed_dim=1024, patch_size=14, vision_width=1280, vision_layers=32,
        vision_heads=16, text_width=1024, text_heads=16, text_layers=24,
        quick_gelu=True,
    ),
}


def get_clip_config(model_name: str) -> CLIPConfig:
    if model_name in CLIP_CONFIGS:
        return CLIP_CONFIGS[model_name]
    raise ValueError(
        f"unknown CLIP model {model_name}; the port knows "
        f"{sorted(CLIP_CONFIGS)}"
    )


def production_clip_config(model_name: str) -> CLIPConfig:
    """The extractor's inference config, read from the same environment
    variables as wise_tpu's: bf16 activations by default
    (WISE_CLIP_DTYPE=float32 to override), the block kernels for bf16 towers
    (WISE_FUSED_BLOCK=0 to disable; the attention middle then still runs as
    a kernel unless WISE_FUSED_ATTN=0, so the fully plain path is both at
    0), the pooled last layer (WISE_POOL_LAST=0) and the f32 vision stream
    (WISE_BF16_STREAM=1 for bf16)."""
    cfg = get_clip_config(model_name)
    dtype = os.environ.get("WISE_CLIP_DTYPE", "bfloat16")
    bf16 = dtype == "bfloat16"
    return dataclasses.replace(
        cfg,
        dtype="bfloat16" if bf16 else "float32",
        fused_attention=(bf16
                         and os.environ.get("WISE_FUSED_ATTN", "1") != "0"),
        fused_block=bf16 and os.environ.get("WISE_FUSED_BLOCK", "1") != "0",
        pool_last_block=os.environ.get("WISE_POOL_LAST", "1") != "0",
        bf16_stream=os.environ.get("WISE_BF16_STREAM", "0") == "1",
    )
