#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serve paths once on one NVIDIA GPU: OpenCLIP
ViT-B/32 and ViT-H/14 (video frames, with one batch of ViT-L/14 and ViT-B/16)
and CLAP 2023 (audio segments).

    python3 chip_smoke.py                  # env, kernels, every slice
    python3 chip_smoke.py --phase kernels  # env and kernels only
    python3 chip_smoke.py --phase vit_h    # env and the ViT-H/14 slice only
    python3 chip_smoke.py --phase profile  # env and the audio breakdown

Phases, one line each; any failure exits non-zero:

1. env: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the kernel build (nvcc, sm_90a, one process per source)
   from wise_tpu_torch/csrc.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the serve paths' shapes and working dtypes, compared on the op's
   increment over its residual input: max abs error (must be <= 5% of the
   plain increment's max abs), minimum per-token cosine (must be >= 0.999),
   and ms per call of both. Planted faults must fail the same check. The
   CLIP block kernels at the ViT-B/32 vision, CLIP text and CLAP caption
   shapes, at ViT-H/14's vision (256 x 257 x 1280, head_dim 80) and text
   (8 x 77 x 1024) shapes with the split MLP pair and each of its halves,
   and the attention block at ViT-L/14's and ViT-B/16's; planted there: the
   head_dim-64 softmax scale, a query tile left unwritten, h not activated.
   Each row also carries the least time the card could take for its work
   (``bound_ms``: the larger of its operations over 989 TFLOP/s and its
   bytes over 3.35 TB/s, from the shapes). The Swin kernels at HTSAT's four stages at batch 64, with the relative-bias
   table at std 1 and the planted faults zeroed logits, the shift mask
   dropped (shifted blocks) and the relative bias dropped.
3. slice: a WiseProject built from seeded synthetic 224x224 uint8 frames,
   embedded by the port's OpenClipExtractor (ViT-B-32, production config,
   random weights) in batches of 256, written through the feature store and
   DB, indexed as IndexFlatIP, served by the port's REST server on
   localhost, and queried with text over HTTP. Checks the responses, that
   every block kernel launched during the run, and the served top-10 ids
   against a plain-PyTorch run of the same queries.
4. audio: the same for 1,024 seeded synthetic 4 s segments at 48 kHz,
   embedded by the port's ClapExtractor (microsoft/clap/2023, production
   config: HTSAT + GPT2 at full width and depth, random weights) in the
   pipeline's audio batches of 32, searched with ``search_in=audio``. Then
   one 64-segment batch through the HTSAT path of WISE_FUSED_SWIN_BLOCK=0,
   which must launch the window-attention kernel at every stage and agree
   with the block-kernel embeddings (cosine >= 0.999).

5. families: one 64-frame batch through the port's extractor for ViT-L/14
   and ViT-B/16 (full width and depth, random weights), embeddings against
   the plain-PyTorch path (cosine >= 0.999), kernels launched at their
   shapes.
6. vit_h: phase 3 for OpenCLIP ViT-H/14 (vision 257 tokens x 1280, head_dim
   80, 32 layers; text 77 x 1024, 24 layers; 1024-d joint space) on 1,024
   frames in batches of 256; the launch counts of the ingest must equal
   batches x (layers - 1) for the attention block and the split MLP, and
   batches for the pooled block.

The line before the last is the kernels' JSON summary; the last is
{"ok": true, "device": {...}}. Needs one CUDA card; imports no JAX.

``--phase profile`` runs the env phase, then breaks one 64-segment audio
batch and one 256-frame ViT-H/14 batch on the kernel path down on
``[profile]`` lines (see phase_profile, profile_vit_h); it checks nothing
and prints no summary.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FRAMES = 4096  # synthetic 224x224 frames ingested by the slice phase
MODEL_ID = "mlfoundations/open_clip/ViT-B-32/laion2b_s34b_b79k"
VIT_H_ID = "mlfoundations/open_clip/ViT-H-14/laion2b_s32b_b79k"
VIT_H_FRAMES = 1024
#: further towers the extended attention kernels open: one batch each
FAMILY_IDS = ["mlfoundations/open_clip/ViT-L-14/laion2b_s32b_b82k",
              "mlfoundations/open_clip/ViT-B-16/laion2b_s34b_b88k"]
QUERIES = ["a dog running on the beach", "people cooking in a kitchen",
           "a red car at night", "snow on the mountains", "a cat asleep",
           "children playing football", "a city street in the rain",
           "fireworks over a river"]
AUDIO_ID = "microsoft/clap/2023/four-datasets"
SEGMENTS = 1024  # synthetic 4 s segments at 48 kHz ingested by the audio phase
AUDIO_QUERIES = ["a dog barking", "rain on a window", "a violin solo",
                 "people talking in a cafe", "a car engine starting",
                 "birds singing at dawn", "applause in a hall",
                 "a door slamming"]
#: wrapper -> (source, TPU kernel it replaces)
KERNELS = {
    "fused_attn_block": ("wise_tpu_torch/csrc/block_kernels.cu",
                         "wise_tpu/ops/block.py:466"),
    "fused_mlp_block": ("wise_tpu_torch/csrc/block_kernels.cu",
                        "wise_tpu/ops/block.py:916"),
    "fused_attn_block_pooled": ("wise_tpu_torch/csrc/block_kernels.cu",
                                "wise_tpu/ops/block.py:634"),
    "fused_attn_block_pooled_dyn": ("wise_tpu_torch/csrc/block_kernels.cu",
                                    "wise_tpu/ops/block.py:811"),
    "fused_mlp_split": ("wise_tpu_torch/csrc/block_kernels.cu",
                        "wise_tpu/ops/block.py:1209"),
    "fused_mlp_fc": ("wise_tpu_torch/csrc/block_kernels.cu",
                     "wise_tpu/ops/block.py:1129"),
    "fused_mlp_proj": ("wise_tpu_torch/csrc/block_kernels.cu",
                       "wise_tpu/ops/block.py:1158"),
    "fused_swin_block": ("wise_tpu_torch/csrc/swin_kernels.cu",
                         "wise_tpu/ops/swin_block.py:227"),
    "fused_window_attention": ("wise_tpu_torch/csrc/swin_kernels.cu",
                               "wise_tpu/ops/swin_attention.py:129"),
}
#: HTSAT's window batches at batch 64: (tag, windows N, C, heads, n_win of
#: the shift mask or None); L = 64 tokens (window 8) throughout
SWIN_STAGES = [("stage0", 4096, 96, 4, None),
               ("stage0-shifted", 4096, 96, 4, 64),
               ("stage1-shifted", 1024, 192, 8, 16),
               ("stage2-shifted", 256, 384, 16, 4),
               ("stage3", 64, 768, 32, None)]


#: published dense peaks of one H100 SXM: bf16 operations/s, HBM bytes/s
PEAK_OPS, PEAK_BYTES = 989e12, 3.35e12


class PhaseError(RuntimeError):
    pass


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_env(torch, verbose_build: bool) -> str:
    from wise_tpu_torch.ops import build

    card = card_line()
    t0 = time.perf_counter()
    build.build(verbose=verbose_build)
    build.load_library()
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)),
        build_s=f"{time.perf_counter() - t0:.3f}",
        nvcc_s=f"{build.build_seconds:.3f}")
    return card


def _cuda_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _block_inputs(torch, b, sp, d, dtype, seed, mlp=False):
    """x ~ N(0, 1); kernels at 1/sqrt(fan_in), as init_random_ draws them,
    so that each block adds about as much as x carries; biases and the
    LayerNorm offsets N(0, 0.02)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=0.02):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    f = 4 * d if mlp else d
    first = (d, 4 * d) if mlp else (d, 3 * d)
    x = r(b, sp, d, scale=1.0).to(dtype)
    ln = (1.0 + r(d), r(d))
    w = (r(*first, scale=d ** -0.5), r(first[1]), r(f, d, scale=f ** -0.5),
         r(d))
    return x, ln, tuple(t.to(torch.bfloat16) for t in w)


def _zero_q(w, d):
    """wqkv and bqkv with the q columns zeroed: every logit 0, so softmax
    attends uniformly over the unmasked keys."""
    wqkv, bqkv = w[0].clone(), w[1].clone()
    wqkv[:, :d] = 0
    bqkv[:d] = 0
    return (wqkv, bqkv, *w[2:])


def _bound(ops: float, nbytes: float):
    """(ms, which) of the least time the card could take: the larger of the
    operations over the bf16 peak and the bytes over the memory rate."""
    by_ops, by_bytes = 1e3 * ops / PEAK_OPS, 1e3 * nbytes / PEAK_BYTES
    return ((by_ops, "operations") if by_ops >= by_bytes
            else (by_bytes, "bytes"))


def _check_row(torch, results, name, tag, key, x, kernel, plain, base,
               faults, work):
    """Hold ``kernel()`` against ``plain()`` on their increment over
    ``base`` (ops.block.increment_agreement); every zero-argument callable
    in ``faults`` (a planted fault) must fail the same check. Times both
    with CUDA events and appends the row to ``results``. ``work`` is the
    call's (operations, bytes): each input read once, each output written
    once. None of these wrappers has a single PyTorch library call that
    computes the same function (each is a LayerNorm, GEMMs with epilogues
    and an attention, or a half of that), so ``library_ms`` is None."""
    from wise_tpu_torch.ops.block import increment_agreement

    with torch.inference_mode():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise PhaseError(f"{name}[{tag}]: {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
        check = increment_agreement(got, want, base)
        planted = {k: increment_agreement(f(), want, base)
                   for k, f in faults.items()}
        ms = _cuda_ms(torch, kernel, 20)
        plain_ms = _cuda_ms(torch, plain, 20)
    caught = not any(c["ok"] for c in planted.values())
    ok = check["ok"] and caught
    bound_ms, bound_by = _bound(*work)
    say("kernels", name=f"{name}[{tag}]",
        shape="x".join(map(str, x.shape)), dtype=str(x.dtype)[6:],
        max_abs_err=f"{check['max_abs_err']:.6g}",
        err_bound=f"{check['err_bound']:.6g}",
        min_cos=f"{check['min_cos']:.6f}",
        planted_min_cos=",".join(f"{k}:{c['min_cos']:.4f}"
                                 for k, c in planted.items()),
        planted="FAIL(expected)" if caught else "PASSED(wrong)",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        status="ok" if ok else "FAIL")
    results.append(dict(name=name, tag=tag, key=key,
                        max_abs_err=check["max_abs_err"], ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None, ok=ok))


#: the block kernels' serve shapes. ViT-B/32: vision (B=256 bucket, f32
#: stream), CLIP text and the CLAP caption tower (B=8, SP=77, bf16 stream,
#: causal). ViT-H/14: vision (257 tokens, head_dim 80) and text (width
#: 1024), whose MLP is the split pair. ViT-L/14 and ViT-B/16: the attention
#: block alone, at the batch the families phase runs.
BLOCK_SHAPES = {
    "vision": dict(b=256, sp=50, d=768, heads=12, f32=True, causal=False,
                   act="gelu", seeds=(1, 11, 3)),
    "text": dict(b=8, sp=77, d=512, heads=8, f32=False, causal=True,
                 act="gelu", seeds=(2, 12, 4)),
    "caption": dict(b=8, sp=77, d=768, heads=12, f32=False, causal=True,
                    act="gelu_tanh", seeds=(5, 15, 6)),
    "vit_h": dict(b=256, sp=257, d=1280, heads=16, f32=True, causal=False,
                  act="gelu", seeds=(31, 32, 33)),
    "vit_h_text": dict(b=8, sp=77, d=1024, heads=16, f32=False, causal=True,
                       act="gelu", seeds=(34, 35, 36)),
    "vit_l": dict(b=64, sp=257, d=1024, heads=16, f32=True, causal=False,
                  act="gelu", seeds=(37, 0, 0), only_attn=True),
    "vit_b16": dict(b=64, sp=197, d=768, heads=12, f32=True, causal=False,
                    act="gelu", seeds=(38, 0, 0), only_attn=True),
}
#: bytes of one LayerNorm's f32 scale and bias, per channel
_LN_BYTES = 8


def _attn_work(b, sp, d, xb, keys, pooled=False):
    """(operations, bytes) of the attention block on x (b, sp, d) of ``xb``
    bytes an element, each query attending to ``keys`` keys on average
    (causal: what the mask leaves). Pooled: k/v for every row, q, attention
    and out-proj for one row an example."""
    m = b * sp
    weights = (4 * d * d + 4 * d) * 2 + _LN_BYTES * d
    if pooled:
        return (4 * m * d * d + 4 * b * d * d + 4 * b * keys * d,
                m * d * xb + b * d * xb + weights)
    return 8 * m * d * d + 4 * m * keys * d, 2 * m * d * xb + weights


def _mlp_work(m, d, f, xb, half=None):
    """(operations, bytes) of the MLP block on m rows; ``half`` "fc" (x in,
    h out) or "proj" (h and x in, out)."""
    if half == "fc":
        return (2 * m * d * f,
                m * d * xb + (d * f + f) * 2 + _LN_BYTES * d + m * f * 2)
    if half == "proj":
        return 2 * m * d * f, m * f * 2 + (d * f + d) * 2 + 2 * m * d * xb
    return (4 * m * d * f,
            2 * m * d * xb + (2 * d * f + f + d) * 2 + _LN_BYTES * d)


def _wrong_scale(w, d, hd):
    """wqkv and bqkv with the q columns scaled so that the logits come out
    as if the softmax scale were 1/8 (head_dim 64's) instead of
    1/sqrt(hd)."""
    wqkv, bqkv = w[0].clone(), w[1].clone()
    wqkv[:, :d] *= 0.125 * math.sqrt(hd)
    bqkv[:d] *= 0.125 * math.sqrt(hd)
    return (wqkv, bqkv, *w[2:])


def _block_rows(torch, results, tag, s):
    """The attention and MLP blocks at one shape, and its pooled block
    (static row 0 for vision, per-example rows for the causal towers); the
    MLP is the wrapper ``mlp_choice`` gives the width, and the split pair
    also goes half by half. Planted faults: the kernel with its logits
    zeroed (for the MLP: its activation dropped), a block that returns its
    residual input; at head_dim 80 the head_dim-64 softmax scale; over 64
    tokens a query tile (rows 64..127) left as the residual input."""
    from wise_tpu_torch.ops import block as K

    b, sp, d, h, causal = s["b"], s["sp"], s["d"], s["heads"], s["causal"]
    dtype = torch.float32 if s["f32"] else torch.bfloat16
    xb = 4 if s["f32"] else 2
    seed_attn, seed_mlp, seed_pool = s["seeds"]
    kw = dict(heads=h, n_valid=sp, causal=causal)
    keys = (sp + 1) / 2 if causal else sp

    x, ln, w = _block_inputs(torch, b, sp, d, dtype, seed_attn)

    def attn(w=w):
        return K.fused_attn_block(x, *ln, *w, **kw)

    def tile_dropped():
        out = attn().clone()
        out[:, 64:128] = x[:, 64:128]
        return out

    faults = {"faulted_kernel": lambda: attn(_zero_q(w, d)),
              "block_skipped": lambda: x}
    if d // h != 64:
        faults["scale_of_hd64"] = lambda: attn(_wrong_scale(w, d, d // h))
    if sp > 64:
        faults["tile_dropped"] = tile_dropped
    _check_row(torch, results, "fused_attn_block", tag,
               ("fused_attn_block", sp, d), x, attn,
               lambda: K.plain_attn_block(x, *ln, *w, **kw), x, faults,
               _attn_work(b, sp, d, xb, keys))
    if s.get("only_attn"):
        return

    x, ln, w = _block_inputs(torch, b, sp, d, dtype, seed_mlp, mlp=True)
    act, f = s["act"], 4 * d
    if K.mlp_choice(d) == "single":
        _check_row(torch, results, "fused_mlp_block", tag,
                   ("fused_mlp_block", sp, d), x,
                   lambda: K.fused_mlp_block(x, *ln, *w, act=act),
                   lambda: K.plain_mlp_block(x, *ln, *w, act=act), x,
                   {"faulted_kernel": lambda: K.fused_mlp_block(
                       x, *ln, *w, act="none"),
                    "block_skipped": lambda: x},
                   _mlp_work(b * sp, d, f, xb))
    else:
        fc, proj = w[:2], w[2:]
        _check_row(torch, results, "fused_mlp_split", tag,
                   ("fused_mlp_split", sp, d), x,
                   lambda: K.fused_mlp_split(x, *ln, *w, act=act),
                   lambda: K.plain_mlp_split(x, *ln, *w, act=act), x,
                   {"h_not_activated": lambda: K.fused_mlp_split(
                       x, *ln, *w, act="none"),
                    "block_skipped": lambda: x},
                   _mlp_work(b * sp, d, f, xb))
        # the first half has no residual: its increment is its whole output
        _check_row(torch, results, "fused_mlp_fc", tag,
                   ("fused_mlp_fc", sp, d), x,
                   lambda: K.fused_mlp_fc(x, *ln, *fc, act=act),
                   lambda: K.plain_mlp_fc(x, *ln, *fc, act=act),
                   torch.zeros((), device="cuda"),
                   {"h_not_activated": lambda: K.fused_mlp_fc(
                       x, *ln, *fc, act="none")},
                   _mlp_work(b * sp, d, f, xb, "fc"))
        with torch.inference_mode():
            hid = K.plain_mlp_fc(x, *ln, *fc, act=act)
            raw = K.plain_mlp_fc(x, *ln, *fc, act="none")
        _check_row(torch, results, "fused_mlp_proj", tag,
                   ("fused_mlp_proj", sp, d), x,
                   lambda: K.fused_mlp_proj(hid, *proj, x),
                   lambda: K.plain_mlp_proj(hid, *proj, x), x,
                   {"h_not_activated": lambda: K.fused_mlp_proj(
                       raw, *proj, x),
                    "block_skipped": lambda: x},
                   _mlp_work(b * sp, d, f, xb, "proj"))
        del hid, raw

    x, ln, w = _block_inputs(torch, b, sp, d, dtype, seed_pool)
    if causal:
        name = "fused_attn_block_pooled_dyn"
        rows = torch.tensor([3, 76, 0, 40, 11, 76, 25, 7], dtype=torch.int32,
                            device="cuda")
        base = x[torch.arange(b, device="cuda"), rows.long()]
        keys = float(rows.float().mean()) + 1

        def pooled(w=w):
            return K.fused_attn_block_pooled_dyn(x, rows, *ln, *w, **kw)

        def plain():
            return K.plain_attn_block_pooled_dyn(x, rows, *ln, *w, **kw)
    else:
        name, base = "fused_attn_block_pooled", x[:, 0]

        def pooled(w=w):
            return K.fused_attn_block_pooled(x, *ln, *w, pool_row=0, **kw)

        def plain():
            return K.plain_attn_block_pooled(x, *ln, *w, pool_row=0, **kw)

    faults = {"faulted_kernel": lambda: pooled(_zero_q(w, d)),
              "block_skipped": lambda: base}
    if d // h != 64:
        faults["scale_of_hd64"] = lambda: pooled(_wrong_scale(w, d, d // h))
    _check_row(torch, results, name, tag, (name, sp, d), x, pooled, plain,
               base, faults, _attn_work(b, sp, d, xb, keys, pooled=True))


def _swin_inputs(torch, n, c, heads, n_win, seed):
    """A window batch (N, 64, C) bf16 ~ N(0, 1); kernels at 1/sqrt(fan_in),
    biases and LayerNorm offsets N(0, 0.02); the relative-bias table at
    std 1 (at 0.02 a kernel that dropped it would still pass); the shift
    mask of a res x res map (n_win windows) or None."""
    from wise_tpu_torch.models.clap.model import (relative_position_index,
                                                  shift_attn_mask)

    g = torch.Generator(device="cuda").manual_seed(seed)
    bf, ff, window, l = torch.bfloat16, 4 * c, 8, 64

    def r(*shape, scale=0.02):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    x = r(n, l, c, scale=1.0).to(bf)
    table = r((2 * window - 1) ** 2, heads, scale=1.0)
    idx = torch.from_numpy(relative_position_index(window).reshape(-1))
    bias = table[idx.cuda()].reshape(l, l, heads).permute(2, 0, 1)
    mask = None
    if n_win:
        res = window * math.isqrt(n_win)
        mask = torch.from_numpy(shift_attn_mask(res, res, window,
                                                window // 2)).cuda()
    attn = (r(c, 3 * c, scale=c ** -0.5).to(bf), r(3 * c).to(bf),
            r(c, c, scale=c ** -0.5).to(bf), r(c).to(bf))
    ln = (1.0 + r(c), r(c), 1.0 + r(c), r(c))
    mlp = (r(c, ff, scale=c ** -0.5).to(bf), r(ff).to(bf),
           r(ff, c, scale=ff ** -0.5).to(bf), r(c).to(bf))
    return x, attn, bias.contiguous(), mask, ln, mlp


def _swin_rows(torch, results):
    """Both Swin kernels at HTSAT's window batches (batch 64). Planted
    faults: zeroed logits (q weights, relative bias and mask all zero:
    uniform attention), the relative bias dropped, and on shifted blocks
    the shift mask dropped. The window attention has no residual: its
    increment is its whole output."""
    from wise_tpu_torch.ops import swin_attention as SA
    from wise_tpu_torch.ops import swin_block as SB

    for i, (tag, n, c, heads, n_win) in enumerate(SWIN_STAGES):
        x, attn, bias, mask, ln, mlp = _swin_inputs(torch, n, c, heads,
                                                    n_win, 20 + i)
        no_bias = torch.zeros_like(bias)
        for name, kernel_fn, plain_fn, base in (
                ("fused_window_attention", SA.fused_window_attention,
                 SA.plain_window_attention, torch.zeros((), device="cuda")),
                ("fused_swin_block", SB.fused_swin_block,
                 SB.plain_swin_block, x)):
            block = name == "fused_swin_block"

            def call(fn, attn=attn, bias=bias, mask=mask, block=block):
                if block:
                    return fn(x, *ln[:2], *attn, bias, mask, *ln[2:], *mlp,
                              heads=heads)
                return fn(x, *attn, bias, mask, heads=heads)

            faults = {
                "logits_zeroed": lambda k=kernel_fn: call(
                    k, _zero_q(attn, c), no_bias, None),
                "bias_dropped": lambda k=kernel_fn: call(k, bias=no_bias)}
            if mask is not None:
                faults["mask_dropped"] = lambda k=kernel_fn: call(k,
                                                                  mask=None)
            # 64-token windows: qkv + out-proj GEMMs and the attention, the
            # block also its MLP (F = 4C); bf16 stream, f32 bias and mask
            m = n * 64
            ops = 8 * m * c * c + 4 * m * 64 * c
            nbytes = (2 * m * c * 2 + (4 * c * c + 4 * c) * 2
                      + bias.numel() * 4
                      + (mask.numel() * 4 if mask is not None else 0))
            if block:
                ops += 16 * m * c * c
                nbytes += (8 * c * c + 5 * c) * 2 + 2 * _LN_BYTES * c
            _check_row(torch, results, name, tag,
                       (name, 64, c, n_win is not None), x,
                       lambda k=kernel_fn: call(k),
                       lambda p=plain_fn: call(p), base, faults,
                       (ops, nbytes))


def phase_kernels(torch):
    """Each kernel against its plain version at the serve paths' shapes
    (BLOCK_SHAPES, SWIN_STAGES), on the op's increment over its residual
    input, with planted faults that must fail the same check."""
    results = []
    for tag, shape in BLOCK_SHAPES.items():
        _block_rows(torch, results, tag, shape)
    _swin_rows(torch, results)
    bad = [f"{r['name']}[{r['tag']}]" for r in results if not r["ok"]]
    if bad:
        raise PhaseError(f"kernels disagree with their plain versions, or "
                         f"the check missed a planted fault: {bad}")
    return results


def _frames(seed: int, n: int, size: int):
    """Seeded synthetic frames: a coarse random 7x7 colour layout upsampled
    to the frame size, plus pixel noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cell = -(-size // 7)
    base = rng.integers(0, 256, (n, 7, 7, 3), dtype=np.int16)
    img = np.repeat(np.repeat(base, cell, 1), cell, 2)[:, :size, :size]
    img = img + rng.integers(-20, 21, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _ingest(project_dir: Path, extractor, model_id: str, clips,
            audio: bool = False):
    """Register one media row per clip and embed it through the extract
    pipeline's batched embedder, feature store and DB writes: a clip is a
    (frames, 224, 224, 3) uint8 VIDEO at 2 fps, in batches of 256, or with
    ``audio`` an (n, 192000) float32 AUDIO file of n 4 s segments at
    48 kHz, in the pipeline's audio batches of 256 // 8 = 32."""
    import numpy as np
    from wise_tpu_torch import config, data_models as dm, db, project, store
    from wise_tpu_torch.db import repository
    from wise_tpu_torch.pipeline.extract import (ExtractionStats,
                                                 _BatchedEmbedder)

    modality = "audio" if audio else "video"
    cfg = config.WiseConfig()
    proj = project.WiseProject(project_dir, create_project=True)
    proj.save_config(cfg)
    conn = db.init_project(proj.db_path)
    sc = repository.SourceCollectionRepo().create(conn, dm.SourceCollection(
        location=str(project_dir / "media"),
        type=dm.SourceCollectionType.DIR))
    fstore = store.FeatureStoreFactory.create_store(
        cfg.store.store_type, modality, proj.create_features_dir(model_id))
    fstore.enable_write(cfg.store.shard_maxcount, cfg.store.shard_maxsize)
    stats = ExtractionStats()
    embedder = _BatchedEmbedder(
        extractor, fstore, conn, dm.ModalityType(modality),
        256 // 8 if audio else 256, stats, f"num_{modality}_vectors")
    seg_s = cfg.audio.segment_length
    t0 = time.perf_counter()
    for i, clip in enumerate(clips):
        if audio:
            meta = dict(path=f"clip{i:03d}.wav", media_type=dm.MediaType.AUDIO,
                        format="wav", width=0, height=0,
                        duration=seg_s * len(clip))
        else:
            meta = dict(path=f"clip{i:03d}.mp4", media_type=dm.MediaType.VIDEO,
                        format="mp4", width=clip.shape[2],
                        height=clip.shape[1], num_frames=len(clip),
                        duration=len(clip) / 2)
        media = repository.MediaRepo().create(conn, dm.MediaMetadata(
            source_collection_id=sc.id, **meta))
        if audio:
            for j, seg in enumerate(clip):
                embedder.add_segment(media.id, seg, seg_s * j, seg_s * (j + 1))
        else:
            embedder.add_frames(media.id, clip,
                                np.arange(len(clip), dtype=np.float64) / 2)
    embedder.finish()
    fstore.close()
    conn.commit()
    conn.close()
    n = stats.audio_segments_embedded if audio else stats.frames_embedded
    return n, time.perf_counter() - t0


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=300) as r:
        if r.status != 200:
            raise PhaseError(f"GET {url}: HTTP {r.status}")
        return json.loads(r.read())


def _served_top(resp, k: int, media: str = "video"):
    """(vector ids, distances) of a /search response, best first."""
    vr = resp.get(f"{media}_results") or {}
    wins = vr.get("unmerged_windows")
    if not isinstance(wins, list) or len(wins) != k or not vr.get(f"{media}s"):
        raise PhaseError(f"malformed search response: {str(resp)[:300]}")
    pairs = [(int(w["vector_id"]), float(w["distance"])) for w in wins]
    if not all(math.isfinite(d) and -1.01 <= d <= 1.01 for _, d in pairs):
        raise PhaseError(f"non-finite or out-of-range distances: {pairs}")
    pairs.sort(key=lambda p: (-p[1], p[0]))
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _check_against_plain(served_ids, served_d, plain_scores, ids, k, tol):
    """The served top-k against the plain run's ranking: the same ids up to
    swaps between scores within ``tol``, distances within ``tol`` (plus the
    response's 3-decimal rounding) of the plain scores."""
    import numpy as np

    by_id = dict(zip(ids.tolist(), plain_scores.tolist()))
    order = np.lexsort((ids, -plain_scores))[:k]
    plain_top = plain_scores[order]
    got = np.array([by_id[i] for i in served_ids])
    if np.abs(np.sort(got)[::-1] - plain_top).max() > tol:
        raise PhaseError(
            f"served ids {served_ids} are not the plain top-{k} "
            f"{ids[order].tolist()} (plain scores {got} vs {plain_top})")
    if np.abs(got - np.array(served_d)).max() > tol + 5e-4:
        raise PhaseError(f"served distances {served_d} vs plain {got}")


def _serve_queries(project_dir: Path, config, queries, k: int,
                   media: str = "video"):
    """Serve the project over REST on localhost (coalescing on) and send a
    warm-up, every query three times in turn, and a burst of every query at
    once. Returns ({query: (ids, distances)}, sequential latencies in s);
    the burst must return what the sequential requests did."""
    from wise_tpu_torch.api.server import create_server

    config.serve.coalesce = True
    server = create_server(project_dir, "127.0.0.1", 0, config=config)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = (f"http://127.0.0.1:{server.server_address[1]}/"
            f"{project_dir.name}/search?search_in={media}&end={k}&q=")
    served, lat, burst = {}, [], {}

    def fetch(q, out):
        out[q] = _served_top(_get_json(base + urllib.parse.quote(q)), k,
                             media)

    try:
        _get_json(base + "warm")
        for _ in range(3):
            for q in queries:
                t0 = time.perf_counter()
                fetch(q, served)
                lat.append(time.perf_counter() - t0)
        workers = [threading.Thread(target=fetch, args=(q, burst))
                   for q in queries]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    if set(burst) != set(queries):
        raise PhaseError("concurrent requests failed")
    for q in queries:
        if burst[q][0] != served[q][0]:
            raise PhaseError(f"{q!r}: concurrent and sequential top-{k} "
                             f"differ: {burst[q][0]} vs {served[q][0]}")
    return served, lat


def _vector_ids(project_dir: Path):
    import numpy as np
    from wise_tpu_torch import db, project

    conn = db.connect(project.WiseProject(project_dir).db_path, readonly=True)
    ids = np.array([r[0] for r in conn.execute(
        "SELECT id FROM vectors ORDER BY id")])
    conn.close()
    return ids


def _plain_twin(torch, extractor):
    """The extractor on the plain PyTorch path (``fused_block`` off) with
    the same weights: a shallow copy around a second model on the card."""
    import copy
    import dataclasses

    from wise_tpu_torch.models.clip.model import CLIP

    with torch.device(extractor.device):
        model = CLIP(dataclasses.replace(extractor.config, fused_block=False))
    model.load_state_dict(extractor.model.state_dict())
    twin = copy.copy(extractor)
    twin.config = model.config
    twin.model = model.eval().requires_grad_(False)
    return twin


def _block_launches():
    """The block wrappers' launch counts by (wrapper, SP, D). The split MLP
    pair launches nothing of its own (its halves count themselves), so its
    count at a shape is derived here: the lesser of its halves' counts."""
    from wise_tpu_torch.ops.block import LAUNCHES_BY_SHAPE

    counts = dict(LAUNCHES_BY_SHAPE)
    for (name, *shape), n in LAUNCHES_BY_SHAPE.items():
        if name == "fused_mlp_fc":
            pair = min(n, counts.get(("fused_mlp_proj", *shape), 0))
            if pair:
                counts[("fused_mlp_split", *shape)] = pair
    return counts


def _tower_keys(config):
    """(vision keys, text keys) of the launch counters a CLIP config's
    towers reach: (wrapper, tokens, width) of the attention block, the MLP
    wrapper its width takes, and the pooled last layer."""
    from wise_tpu_torch.ops.block import mlp_choice

    def keys(sp, d, pooled):
        mlp = ("fused_mlp_block" if mlp_choice(d) == "single"
               else "fused_mlp_split")
        return [("fused_attn_block", sp, d), (mlp, sp, d), (pooled, sp, d)]

    c = config
    n_tok = (c.image_size // c.patch_size) ** 2 + 1
    return (keys(n_tok, c.vision_width, "fused_attn_block_pooled"),
            keys(c.context_length, c.text_width,
                 "fused_attn_block_pooled_dyn"))


def phase_slice(torch, card, model_id=MODEL_ID, n_frames=FRAMES,
                phase="slice", topk_1m=True, size=224, k=10):
    """Ingest -> IndexFlatIP -> REST on the port; returns the launch counts
    of the main path's run, keyed by (wrapper, SP, D). The vision tower's
    counts must be exact: batches x (layers - 1) for the attention block and
    the MLP, batches for the pooled last layer."""
    import numpy as np
    from wise_tpu_torch import project
    from wise_tpu_torch.cli import create_index
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.ops.topk import flat_topk

    clip_len = 256
    seeds = range((n_frames + clip_len - 1) // clip_len)
    clips = [_frames(s, min(clip_len, n_frames - s * clip_len), size)
             for s in seeds]
    with tempfile.TemporaryDirectory(prefix="wise_smoke_") as tmp:
        project_dir = Path(tmp) / "proj"
        t0 = time.perf_counter()
        extractor = OpenClipExtractor(model_id)
        build_s = time.perf_counter() - t0
        with torch.inference_mode():  # first use: cuBLAS, kernel library
            extractor.extract_image_features(clips[0][:8])
            extractor.extract_text_features(["warm up"])

        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        n, ingest_s = _ingest(project_dir, extractor, model_id, clips)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if n != n_frames:
            raise PhaseError(f"embedded {n} of {n_frames} frames")
        vision, text = _tower_keys(extractor.config)
        layers = extractor.config.vision_layers
        want = dict(zip(vision, [len(clips) * (layers - 1)] * 2
                        + [len(clips)]))
        launches = _block_launches()
        got = {key: launches.get(key, 0) for key in vision}
        if got != want:
            raise PhaseError(f"{phase}: ingest launched {got}, expected "
                             f"{want}")
        if create_index.main(["--project-dir", str(project_dir)]) != 0:
            raise PhaseError("create-index failed")
        config = project.WiseProject(project_dir).load_config()
        served, lat = _serve_queries(project_dir, config, QUERIES, k)
        launches = _block_launches()
        idle = [key for key in vision + text if not launches.get(key)]
        if idle:
            raise PhaseError(f"{phase}: not launched on the path: {idle}")

        # the same frames and queries through the plain PyTorch path
        plain = _plain_twin(torch, extractor)
        ids = _vector_ids(project_dir)
        vecs = np.concatenate([
            np.concatenate([plain.extract_image_features(c[i:i + 256])
                            for i in range(0, len(c), 256)])
            for c in clips])
        if _block_launches() != launches:
            raise PhaseError(f"{phase}: the plain run launched kernels")
        prefix = config.search.query_prefix
        for q in QUERIES:
            qv = plain.extract_text_features([f"{prefix} {q}".strip()])[0]
            scores = (torch.from_numpy(vecs) @ torch.from_numpy(qv)).numpy()
            _check_against_plain(*served[q], scores, ids, k, 1e-3)

        fields = {}
        if topk_1m:
            # text embed + exact flat top-k p50 on a device-resident 1M x
            # 512 database (flat_topk called directly: no index, HTTP or
            # hydration)
            g = torch.Generator(device=extractor.device).manual_seed(0)
            big = torch.randn(1 << 20, extractor.output_dim, generator=g,
                              device=extractor.device)
            big = big / big.norm(dim=1, keepdim=True)
            lat_1m = []
            for i in range(25):
                t0 = time.perf_counter()
                qv = extractor.extract_text_features([QUERIES[i % 8]])
                _, rows = flat_topk(torch.from_numpy(qv), big,
                                    n_valid=big.shape[0], k=k)
                rows.cpu()
                lat_1m.append(time.perf_counter() - t0)
            del big
            fields["embed_topk_1M_p50_ms"] = (
                f"{1e3 * float(np.median(lat_1m[5:])):.3f}")
        rates = {name: _encode_rates(torch, fe, clips[0])
                 for name, fe in (("kernels", extractor), ("plain", plain))}

    say(phase, card=repr(card), model=model_id.split("/")[2], frames=n,
        extractor_build_s=f"{build_s:.3f}", ingest_s=f"{ingest_s:.3f}",
        frames_per_s=f"{n / ingest_s:.1f}",
        ingest_peak_device_gb=f"{peak_gb:.3f}", requests=len(lat) + 9,
        query_p50_ms=f"{1e3 * float(np.median(lat)):.3f}", **fields,
        launches=json.dumps({_launch_name(key): c for key, c
                             in sorted(launches.items())},
                            separators=(",", ":")),
        vs_plain="ok")
    for name, (fps, tower_ms) in rates.items():
        say(phase, card=repr(card), path=name, batch=len(clips[0]),
            extractor_frames_per_s=f"{fps:.1f}",
            device_ms_per_batch=f"{tower_ms:.3f}",
            device_frames_per_s=f"{1e3 * len(clips[0]) / tower_ms:.1f}")
    return launches


def phase_families(torch, card, batch: int = 64):
    """One batch of frames through the port's extractor for each further
    tower the attention kernels take (FAMILY_IDS), at full width and depth:
    embeddings against the plain path, every vision kernel launched.
    Returns the launch counts keyed by (wrapper, SP, D)."""
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.ops import block as K

    frames = _frames(99, batch, 224)
    launches = {}
    for model_id in FAMILY_IDS:
        extractor = OpenClipExtractor(model_id)
        K.reset_launches()
        got = torch.from_numpy(extractor.extract_image_features(frames))
        counts = _block_launches()
        vision, _ = _tower_keys(extractor.config)
        idle = [key for key in vision if not counts.get(key)]
        if idle:
            raise PhaseError(f"families: not launched: {idle}")
        plain = _plain_twin(torch, extractor)
        want = torch.from_numpy(plain.extract_image_features(frames))
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
        ms = _encode_rates(torch, extractor, frames)[1]
        plain_ms = _encode_rates(torch, plain, frames)[1]
        say("families", card=repr(card), model=model_id.split("/")[2],
            batch=batch, min_cos_vs_plain=f"{cos.min().item():.6f}",
            device_ms_per_batch=f"{ms:.3f}",
            plain_device_ms_per_batch=f"{plain_ms:.3f}",
            launches=json.dumps({_launch_name(key): c for key, c
                                 in sorted(counts.items())},
                                separators=(",", ":")))
        if not (got.shape == want.shape and bool(torch.isfinite(got).all())
                and cos.min().item() >= 0.999):
            raise PhaseError(f"families: {model_id} embeddings off the "
                             f"plain path (min cos {cos.min().item():.6f})")
        launches.update(counts)
        del extractor, plain
        torch.cuda.empty_cache()
    return launches


def _segments(torch, n: int, seed: int, chunk: int = 128):
    """n seeded synthetic 4 s segments at 48 kHz, (n, 192000) float32 on
    the host, made on the card: three tones of log-uniform pitch (80 Hz to
    8 kHz), random level and phase, under a slow amplitude envelope, plus
    noise."""
    import numpy as np

    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.arange(192_000, device="cuda") / 48_000.0
    out = []
    for i in range(0, n, chunk):
        m = min(chunk, n - i)

        def r(*shape):
            return torch.rand(*shape, 1, generator=g, device="cuda")

        tones = (0.05 + 0.25 * r(m, 3)) * torch.sin(
            2 * math.pi * (80.0 * 100.0 ** r(m, 3) * t + r(m, 3)))
        env = 0.6 + 0.4 * torch.sin(2 * math.pi * (0.25 + 2 * r(m)) * t)
        sig = tones.sum(1) * env + 0.02 * torch.randn(
            m, t.numel(), generator=g, device="cuda")
        out.append(sig.float().cpu().numpy())
    return np.concatenate(out)


def _window_attention_run(torch, extractor, x):
    """One batch through the HTSAT path of WISE_FUSED_SWIN_BLOCK=0 (f32
    stream blocks around the window-attention kernel) on the extractor's
    weights: (launches by (wrapper, L, C), min embedding cosine against the
    extractor's block-kernel path)."""
    from wise_tpu_torch.models.clap.config import production_clap_config
    from wise_tpu_torch.models.clap.model import CLAP
    from wise_tpu_torch.ops import swin_attention as SA

    os.environ["WISE_FUSED_SWIN_BLOCK"] = "0"
    try:
        cfg = production_clap_config(extractor.version)
    finally:
        del os.environ["WISE_FUSED_SWIN_BLOCK"]
    with torch.device(extractor.device):
        model = CLAP(cfg)
    model.load_state_dict(extractor.model.state_dict())
    model.to(extractor.device).eval()
    with torch.inference_mode():
        mel = extractor.log_mel(x)
        want = extractor.model.encode_audio(mel)
        SA.reset_launches()
        got = model.encode_audio(mel)
        torch.cuda.synchronize()
        launches = dict(SA.LAUNCHES_BY_SHAPE)
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    return launches, cos.min().item()


def phase_audio(torch, card, k=10):
    """Audio ingest -> IndexFlatIP -> REST ``search_in=audio`` on the port's
    CLAP; returns the launch counts of the paths' runs, keyed by (wrapper,
    L, C) and (wrapper, SP, D)."""
    import numpy as np
    from wise_tpu_torch import project
    from wise_tpu_torch.cli import create_index
    from wise_tpu_torch.models.clap.extractor import ClapExtractor
    from wise_tpu_torch.models.clap.model import SwinBlock
    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.ops import swin_block as SB

    segs = _segments(torch, SEGMENTS, seed=7)
    clips = [segs[i:i + 16] for i in range(0, SEGMENTS, 16)]  # 64 s files
    with tempfile.TemporaryDirectory(prefix="wise_smoke_audio_") as tmp:
        project_dir = Path(tmp) / "proj"
        extractor = ClapExtractor(AUDIO_ID)
        c = extractor.config
        # (L, C, masked) of every HTSAT block: each stage, and its shifted
        # blocks apart (stage 3's one window never shifts)
        swin_keys = sorted({(blk.window ** 2, blk.norm1.scale.shape[0],
                             blk.shift > 0)
                            for blk in extractor.model.audio_encoder.modules()
                            if isinstance(blk, SwinBlock)})
        with torch.inference_mode():  # first use: cuBLAS, kernel library
            extractor.extract_audio_features(segs[:32])
            extractor.extract_text_features(["warm up"])

        K.reset_launches()
        SB.reset_launches()
        n, ingest_s = _ingest(project_dir, extractor, AUDIO_ID, clips,
                              audio=True)
        if n != SEGMENTS:
            raise PhaseError(f"embedded {n} of {SEGMENTS} segments")
        if create_index.main(["--project-dir", str(project_dir)]) != 0:
            raise PhaseError("create-index failed")
        config = project.WiseProject(project_dir).load_config()
        served, lat = _serve_queries(project_dir, config, AUDIO_QUERIES, k,
                                     media="audio")
        launches = {**K.LAUNCHES_BY_SHAPE, **SB.LAUNCHES_BY_SHAPE}
        path = [("fused_swin_block", *key) for key in swin_keys] + [
            (name, c.context_length, c.text_width)
            for name in ("fused_attn_block", "fused_mlp_block",
                         "fused_attn_block_pooled_dyn")]
        idle = [key for key in path if not launches.get(key)]
        if idle:
            raise PhaseError(f"not launched on the audio path: {idle}")

        # the same segments and queries through the plain PyTorch path
        os.environ["WISE_FUSED_BLOCK"] = "0"
        try:
            plain = ClapExtractor(AUDIO_ID)
        finally:
            del os.environ["WISE_FUSED_BLOCK"]
        ids = _vector_ids(project_dir)
        vecs = np.concatenate([plain.extract_audio_features(segs[i:i + 64])
                               for i in range(0, SEGMENTS, 64)])
        prefix = config.search.audio_query_prefix
        for q in AUDIO_QUERIES:
            qv = plain.extract_text_features([f"{prefix} {q}".strip()])[0]
            _check_against_plain(*served[q], vecs @ qv, ids, k, 1e-3)

        batch = torch.from_numpy(segs[:64]).to(extractor.device)
        window, cos = _window_attention_run(torch, extractor, batch)
        missing = [key for key in swin_keys
                   if not window.get(("fused_window_attention", *key))]
        if missing or cos < 0.999:
            raise PhaseError(
                f"WISE_FUSED_SWIN_BLOCK=0: window attention idle at (L, C, "
                f"masked) {missing}, or embeddings off the block path (min cos "
                f"{cos:.6f} < 0.999)")
        launches.update(window)
        rates = {name: _audio_rates(torch, fe, segs[:64])
                 for name, fe in (("kernels", extractor), ("plain", plain))}

    say("slice", card=repr(card), media="audio", segments=n,
        ingest_s=f"{ingest_s:.3f}", segments_per_s=f"{n / ingest_s:.1f}",
        requests=len(lat) + 1 + len(AUDIO_QUERIES),
        query_p50_ms=f"{1e3 * float(np.median(lat)):.3f}",
        launches=json.dumps({_launch_name(key): v for key, v
                             in sorted(launches.items())},
                            separators=(",", ":")),
        vs_plain="ok")
    say("slice", card=repr(card), media="audio",
        path="WISE_FUSED_SWIN_BLOCK=0", batch=len(batch),
        window_attention_launches=json.dumps(
            {_launch_name(key): v for key, v in sorted(window.items())},
            separators=(",", ":")),
        min_cos_vs_block_path=f"{cos:.6f}")
    for name, (sps, ms) in rates.items():
        say("slice", card=repr(card), media="audio", path=name,
            batch=len(batch), extractor_segments_per_s=f"{sps:.1f}",
            device_ms_per_batch=f"{ms:.3f}",
            device_segments_per_s=f"{1e3 * len(batch) / ms:.1f}")
    return launches


def _launch_name(key) -> str:
    """A launch counter's key as text: (wrapper, SP, D) of the block
    kernels, (wrapper, L, C, masked) of the Swin kernels."""
    name, a, b, *masked = key
    if masked:
        return f"{name}[L={a},C={b}{',masked' if masked[0] else ''}]"
    return f"{name}[SP={a},D={b}]"


def _device_kernels(torch, fn, reps: int = 3):
    """Device ms per CUDA kernel over ``reps`` calls of ``fn``
    (torch.profiler, kernels only: each kernel's self device time), as
    [(ms a call, launches a call, kernel name)], largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    return sorted(
        ((e.self_device_time_total / (1e3 * reps), e.count / reps, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True)


def _say_kernels(kernels, top: int = 16, **tag):
    say("profile", **tag,
        kernel_ms_per_batch=(f"{sum(k[0] for k in kernels):.4f}"
                             if kernels else "not measured"),
        kernels=len(kernels))
    for k_ms, n, key in kernels[:top]:
        say("profile", **tag, ms=f"{k_ms:.4f}", launches=f"{n:g}",
            kernel=key[:100])


def profile_vit_h(torch, card, batch: int = 256):
    """Where one ViT-H/14 batch's time goes on the kernel path: device ms
    (CUDA events, mean of 3 calls) of preprocess + image tower on 256
    frames, of one text embed, and the device ms per CUDA kernel of the
    image batch (torch.profiler, mean of 2 batches)."""
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor

    fe = OpenClipExtractor(VIT_H_ID)
    frames = _frames(0, batch, 224)
    x = torch.from_numpy(frames).to(fe.device)

    def tower():
        fe.model.encode_image(fe.preprocess_frames(x, 224))

    with torch.inference_mode():
        fe.extract_image_features(frames[:8])  # first use
        fe.extract_text_features(["warm up"])
        ms = dict(
            batch=_cuda_ms(torch, tower, 3),
            preprocess=_cuda_ms(torch, lambda: fe.preprocess_frames(x, 224),
                                3),
            text_embed_1=_cuda_ms(
                torch, lambda: fe.extract_text_features_dispatch(
                    ["a dog barking"]), 3))
    say("profile", card=repr(card), model="ViT-H-14", batch=batch,
        **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()})
    _say_kernels(_device_kernels(torch, tower, 2), model="ViT-H-14")


def phase_profile(torch, card, batch: int = 64, reps: int = 5):
    """Where one audio batch's time goes on the kernel path, one run: device
    ms (CUDA events, mean of ``reps`` calls) of the whole batch at 64 and at
    32 segments, of the log-mel, the HTSAT tower, each of its modules (on
    the input the tower gives it) and the projection; one caption's text
    embed; the extractor's host-to-host ms on a 32-segment ingest batch
    (median); and the device ms per CUDA kernel over three batches
    (torch.profiler, kernels only: each kernel's self device time)."""
    import numpy as np

    from wise_tpu_torch.models.clap.extractor import ClapExtractor

    segs = _segments(torch, batch, seed=7)
    fe = ClapExtractor(AUDIO_ID)
    enc = fe.model.audio_encoder
    x = torch.from_numpy(segs).to(fe.device)

    def cuda_ms(fn):
        return _cuda_ms(torch, fn, reps)

    with torch.inference_mode():
        fe.extract_audio_features(segs[:32])  # first use
        fe.extract_text_features(["warm up"])
        mel = fe.log_mel(x)
        feats = enc(mel)
        ms = dict(
            batch=cuda_ms(lambda: fe.encode_waveforms(x)),
            half_batch=cuda_ms(lambda: fe.encode_waveforms(x[:batch // 2])),
            log_mel=cuda_ms(lambda: fe.log_mel(x)),
            htsat=cuda_ms(lambda: enc(mel)),
            projection=cuda_ms(lambda: fe.model.audio_projection(feats)),
            text_embed_1=cuda_ms(
                lambda: fe.extract_text_features_dispatch(["a dog barking"])))
        modules = {"embed": cuda_ms(lambda: enc.embed(mel))}
        h = enc.embed(mel)
        for names in enc.stages:
            for name in names:
                mod = getattr(enc, name)
                modules[name] = cuda_ms(lambda m=mod, h=h: m(h))
                h = mod(h)
        modules["norm_pool"] = cuda_ms(lambda: enc.norm(h).mean(dim=1))
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fe.extract_audio_features(segs[:32])
        host.append(time.perf_counter() - t0)

    kernels = _device_kernels(torch, lambda: fe.encode_waveforms(x))

    say("profile", card=repr(card), batch=batch,
        **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
        extract_32_host_ms=f"{1e3 * float(np.median(host)):.4f}")
    say("profile", htsat_module_ms=json.dumps(
        {k: round(v, 4) for k, v in modules.items()}, separators=(",", ":")))
    _say_kernels(kernels)


def _audio_rates(torch, extractor, segs, reps: int = 5):
    """(segments/s of extract_audio_features on one batch, host to host;
    device ms of resample + log-mel + audio tower + projection on that
    batch, CUDA events)."""
    extractor.extract_audio_features(segs)
    t0 = time.perf_counter()
    for _ in range(reps):
        extractor.extract_audio_features(segs)
    sps = reps * len(segs) / (time.perf_counter() - t0)
    x = torch.from_numpy(segs).to(extractor.device)
    with torch.inference_mode():
        ms = _cuda_ms(torch, lambda: extractor.encode_waveforms(x), reps)
    return sps, ms


def _encode_rates(torch, extractor, frames, reps: int = 5):
    """(frames/s of extract_image_features on one batch, host to host;
    device ms of preprocess + image tower on that batch, CUDA events)."""
    extractor.extract_image_features(frames)
    t0 = time.perf_counter()
    for _ in range(reps):
        extractor.extract_image_features(frames)
    fps = reps * len(frames) / (time.perf_counter() - t0)
    x = torch.from_numpy(frames).to(extractor.device)
    size = extractor.config.image_size

    def tower():
        extractor.model.encode_image(extractor.preprocess_frames(x, size))

    with torch.inference_mode():
        ms = _cuda_ms(torch, tower, reps)
    return fps, ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["all", "kernels", "vit_h", "profile"],
                    default="all")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc -Xptxas -v (registers, shared memory)")
    args = ap.parse_args(argv)

    if not (ROOT / "wise_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: wise_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        card = phase_env(torch, args.verbose_build)
        if args.phase == "profile":
            phase_profile(torch, card)
            profile_vit_h(torch, card)
            return 0
        if args.phase == "vit_h":
            phase_slice(torch, card, VIT_H_ID, VIT_H_FRAMES, "vit_h",
                        topk_1m=False)
            return 0
        kernels = phase_kernels(torch)
        if args.phase == "kernels":
            return 0
        launches = phase_slice(torch, card)
        launches.update(phase_audio(torch, card))
        launches.update(phase_families(torch, card))
        launches.update(phase_slice(torch, card, VIT_H_ID, VIT_H_FRAMES,
                                    "vit_h", topk_1m=False))
        idle = [f"{r['name']}[{r['tag']}]" for r in kernels
                if not launches.get(r["key"])]
        if idle:
            raise PhaseError(f"not launched on the path at the shape "
                             f"checked: {idle}")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    print(card)
    print(json.dumps({"kernels": [
        {"name": f"{r['name']}[{r['tag']}]", "route": "cuda",
         "source": KERNELS[r["name"]][0], "replaces": KERNELS[r["name"]][1],
         "launches": launches[r["key"]],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for r in kernels
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
