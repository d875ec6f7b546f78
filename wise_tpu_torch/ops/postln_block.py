"""The XLM-RoBERTa text tower's post-LN residual blocks: CUDA kernels and
their plain versions (wise_tpu/ops/postln_block.py).

Each wrapper keeps the JAX wrapper's signature and layout: x (B, SP, D)
bf16, km (B, 1, SP) the additive f32 key mask of each example (0 keep, -inf
drop), weights bf16 in x @ W layout (wqkv (D, 3D) packs the separate q/k/v
projections, wo (D, D), wfc (D, F), wproj (F, D)), biases bf16, LayerNorm
parameters f32; the output is bf16. On a CPU tensor a wrapper computes its
plain version (in x's dtype, so f32 works there); on a CUDA tensor it
launches its kernel chain (csrc/postln_kernels.cu) or raises. ``LAUNCHES``
counts the kernel launches.

| wrapper                          | TPU kernel it replaces (postln_block.py) |
| -------------------------------- | ---------------------------------------- |
| fused_postln_attn_block          | fused_postln_attn_block (:184)           |
| fused_postln_mlp_block "single"  | fused_postln_mlp_block (:277), one       |
|                                  |   program (_postln_mlp_kernel :239)      |
| fused_postln_mlp_block "split"   | the same, two programs: _postln_fc_kernel|
|   (fused_postln_fc then          |   (:257) then _postln_proj_kernel (:265) |
|   fused_postln_proj)             |                                          |
| fused_postln_attn_block_train    | fused_postln_attn_block_train (:468)     |
| fused_postln_mlp_block_train     | fused_postln_mlp_block_train (:487)      |

Rounding points follow the TPU kernels: qkv rounds to bf16 after the bias, p
before the PV product, h after the GELU; the residual sum x + acc + bias is
formed and normalised in f32 and rounds once, after the LayerNorm.

A row whose keys are all masked (km all -inf) is NaN in the kernel, in the
plain version and on the TPU alike (a softmax over nothing); the extractor
never makes one, since every row it pads carries one real token.

The training entries ``fused_postln_attn_block_train`` and
``fused_postln_mlp_block_train`` (the reference's :468 and :487) run the
serve wrappers' kernels forward and, under a gradient, a backward that
differentiates the plain block at the saved inputs (the reference's
``_recompute_bwd``; it has no backward kernel). ``km`` gets no gradient. A
masked key's probability is exactly 0, so it sends nothing back, and a row
with one real key has finite gradients. The serve wrappers refuse a
gradient on the card.
"""

from __future__ import annotations

import math

import torch

from .block import (ACTS, HEAD_DIMS, _check_param, _check_proj, _check_x,
                    _leaves, _needs_grad, _ptrs, _require, _stream,
                    activation, layer_norm_f32)
from .build import LaunchCounter, check, load_library, refuse_grad

_launches = LaunchCounter("fused_postln_attn_block", "fused_postln_mlp_block",
                          "fused_postln_fc", "fused_postln_proj")
#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = _launches.counts
#: the same launches keyed by (wrapper, SP, D) of x
LAUNCHES_BY_SHAPE = _launches.by_shape
reset_launches = _launches.reset

#: what a serve wrapper says when it is called on the card under autograd
_ATTN_TRAIN = "call fused_postln_attn_block_train, which differentiates"
_MLP_TRAIN = "call fused_postln_mlp_block_train, which differentiates"


def postln_mlp_choice(width: int) -> str:
    """Which MLP variant a tower of this width takes: "single" up to width
    768, "split" above (XLM-R large, width 1024). The rule only mirrors the
    reference's calibration table (wise_tpu/ops/postln_block.py:72), where
    the split exists because both weights do not fit VMEM. Here both run the
    same GEMM chain and differ in who owns h."""
    return "single" if width <= 768 else "split"


# ---------------------------------------------------------------------------
# plain versions (the reference math of wise_tpu/ops/postln_block.py
# plain_postln_*): GEMMs in x's dtype, f32 logits, softmax, residual sum and
# LayerNorm
# ---------------------------------------------------------------------------


def plain_postln_attention(x, km, wqkv, bqkv, heads: int):
    """MHA(x, km) before the out-projection, (B, SP, D) in x's dtype."""
    b, sp, d = x.shape
    hd = d // heads
    q, k, v = ((x @ wqkv + bqkv).reshape(b, sp, 3, heads, hd)
               .unbind(dim=2))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(hd)) + km[:, :, None, :]
    p = torch.softmax(logits, dim=-1).to(x.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, sp, d)


def plain_postln_proj(h, wproj, bproj, x, ln_s, ln_b):
    """LN(x + (h @ wproj + b)) in x's dtype: the sum and the LayerNorm in
    f32. Closes both blocks (h is the attention output, or the MLP's)."""
    res = x.float() + (h @ wproj).float() + bproj.float()
    return layer_norm_f32(res, ln_s, ln_b).to(x.dtype)


def plain_postln_fc(x, wfc, bfc, act: str = "gelu"):
    """h = act(x @ wfc + b) in x's dtype, (B, SP, F)."""
    return activation((x @ wfc).float() + bfc.float(), act).to(x.dtype)


def plain_postln_attn_block(x, km, ln_s, ln_b, wqkv, bqkv, wo, bo,
                            heads: int):
    """LN(x + out_proj(MHA(x, km)))."""
    att = plain_postln_attention(x, km, wqkv, bqkv, heads)
    return plain_postln_proj(att, wo, bo, x, ln_s, ln_b)


def plain_postln_mlp_block(x, ln_s, ln_b, wfc, bfc, wproj, bproj,
                           act: str = "gelu"):
    """LN(x + proj(act(fc(x))))."""
    return plain_postln_proj(plain_postln_fc(x, wfc, bfc, act), wproj, bproj,
                             x, ln_s, ln_b)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_stream(x, name: str):
    b, sp, d = _check_x(x, name)
    _require(x.dtype == torch.bfloat16,
             f"{name}: x dtype {x.dtype} != torch.bfloat16")
    return b, sp, d


def _check_ln(ln_scale, ln_bias, d, dev, name):
    _check_param(ln_scale, (d,), torch.float32, dev, f"{name} ln_scale")
    _check_param(ln_bias, (d,), torch.float32, dev, f"{name} ln_bias")


def _check_fc(x, wfc, bfc, act, name):
    _require(act in ACTS, f"{name}: unknown activation {act!r}")
    b, sp, d = _check_stream(x, name)
    f = wfc.shape[-1]
    _require(f % 128 == 0, f"{name}: hidden width {f} not a multiple of 128")
    _check_param(wfc, (d, f), torch.bfloat16, x.device, f"{name} wfc")
    _check_param(bfc, (f,), torch.bfloat16, x.device, f"{name} bfc")
    return b, sp, d, f


def fused_postln_attn_block(x, km, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                            heads: int):
    """x (B, SP, D) bf16, km (B, 1, SP) additive f32 key mask ->
    LN(x + out_proj(MHA(x, km))) as (B, SP, D) bf16. A row whose keys are all
    at -inf comes out as NaN."""
    if not x.is_cuda:
        return plain_postln_attn_block(x, km, ln_scale, ln_bias, wqkv, bqkv,
                                       wo, bo, heads)
    name = "fused_postln_attn_block"
    refuse_grad(name, (x, ln_scale, ln_bias, wqkv, bqkv, wo, bo),
                _ATTN_TRAIN)
    b, sp, d = _check_stream(x, name)
    _require(heads >= 1 and d % heads == 0 and d // heads in HEAD_DIMS,
             f"{name}: head_dim {d / max(heads, 1):g} not in {HEAD_DIMS}")
    dev, bf = x.device, torch.bfloat16
    _check_param(km, (b, 1, sp), torch.float32, dev, f"{name} km")
    _check_ln(ln_scale, ln_bias, d, dev, name)
    _check_param(wqkv, (d, 3 * d), bf, dev, f"{name} wqkv")
    _check_param(bqkv, (3 * d,), bf, dev, f"{name} bqkv")
    _check_param(wo, (d, d), bf, dev, f"{name} wo")
    _check_param(bo, (d,), bf, dev, f"{name} bo")
    lib = load_library()
    m = b * sp
    qkv = torch.empty((m, 3 * d), dtype=bf, device=dev)
    att = torch.empty((m, d), dtype=bf, device=dev)
    res = torch.empty((m, d), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    check(lib.wt_postln_attn_block(
        *_ptrs(x, km, ln_scale, ln_bias, wqkv, bqkv, wo, bo, out, qkv, att,
               res), b, sp, d, heads, _stream(x)), name)
    _launches.add(name, sp, d)
    return out


def fused_postln_fc(x, wfc, bfc, act: str = "gelu"):
    """The first half of the split MLP: x (B, SP, D) bf16 -> h = act(fc(x))
    as (B, SP, F) bf16 in device memory; h rounds once, after the
    activation."""
    if not x.is_cuda:
        return plain_postln_fc(x, wfc, bfc, act)
    name = "fused_postln_fc"
    refuse_grad(name, (x, wfc, bfc), _MLP_TRAIN)
    b, sp, d, f = _check_fc(x, wfc, bfc, act, name)
    lib = load_library()
    h = torch.empty((b, sp, f), dtype=torch.bfloat16, device=x.device)
    check(lib.wt_postln_fc(*_ptrs(x, wfc, bfc, h), b * sp, d, f, ACTS[act],
                           _stream(x)), name)
    _launches.add(name, sp, d)
    return h


def fused_postln_proj(h, wproj, bproj, x, ln_scale, ln_bias):
    """The second half: h (B, SP, F) bf16, x (B, SP, D) bf16 ->
    LN(x + (proj(h) + b)) as bf16."""
    if not x.is_cuda:
        return plain_postln_proj(h, wproj, bproj, x, ln_scale, ln_bias)
    name = "fused_postln_proj"
    refuse_grad(name, (h, wproj, bproj, x, ln_scale, ln_bias), _MLP_TRAIN)
    b, sp, d = _check_stream(x, name)
    f = wproj.shape[0]
    _require(f % 32 == 0, f"{name}: hidden width {f} not a multiple of 32")
    _check_param(h, (b, sp, f), torch.bfloat16, x.device, f"{name} h")
    _check_proj(wproj, bproj, d, f, x.device, name)
    _check_ln(ln_scale, ln_bias, d, x.device, name)
    lib = load_library()
    res = torch.empty((b * sp, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    check(lib.wt_postln_proj(
        *_ptrs(h, wproj, bproj, x, ln_scale, ln_bias, out, res), b * sp, d, f,
        _stream(x)), name)
    _launches.add(name, sp, d)
    return out


def fused_postln_mlp_block(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj,
                           act: str = "gelu", variant: str | None = None):
    """x (B, SP, D) bf16 -> LN(x + proj(act(fc(x)))) as (B, SP, D) bf16.
    ``variant`` "single" runs the whole block as one call on scratch of its
    own; "split" runs fused_postln_fc then fused_postln_proj, with h in the
    caller's memory, and launches nothing of its own (each half counts
    itself). Default: ``postln_mlp_choice`` of the width."""
    variant = variant or postln_mlp_choice(x.shape[-1])
    _require(variant in ("single", "split"),
             f"fused_postln_mlp_block: unknown variant {variant!r}")
    if not x.is_cuda:
        return plain_postln_mlp_block(x, ln_scale, ln_bias, wfc, bfc, wproj,
                                      bproj, act)
    if variant == "split":
        h = fused_postln_fc(x, wfc, bfc, act)
        return fused_postln_proj(h, wproj, bproj, x, ln_scale, ln_bias)
    name = "fused_postln_mlp_block"
    refuse_grad(name, (x, ln_scale, ln_bias, wfc, bfc, wproj, bproj),
                _MLP_TRAIN)
    b, sp, d, f = _check_fc(x, wfc, bfc, act, name)
    _check_proj(wproj, bproj, d, f, x.device, name)
    _check_ln(ln_scale, ln_bias, d, x.device, name)
    lib = load_library()
    m = b * sp
    h = torch.empty((m, f), dtype=torch.bfloat16, device=x.device)
    res = torch.empty((m, d), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    check(lib.wt_postln_mlp_block(
        *_ptrs(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, out, h, res),
        m, d, f, ACTS[act], _stream(x)), name)
    _launches.add(name, sp, d)
    return out


# ---------------------------------------------------------------------------
# autograd rules (wise_tpu/ops/postln_block.py:468-505): the kernel forward,
# the backward a recompute of the plain block at the saved inputs
# ---------------------------------------------------------------------------


class _PostlnAttnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, km, ln_s, ln_b, wqkv, bqkv, wo, bo, heads):
        out = fused_postln_attn_block(x, km, ln_s, ln_b, wqkv, bqkv, wo, bo,
                                      heads)
        ctx.save_for_backward(x, km, ln_s, ln_b, wqkv, bqkv, wo, bo)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, g):
        x, km, *params = ctx.saved_tensors
        x, *params = _leaves(x, *params)
        with torch.enable_grad():
            out = plain_postln_attn_block(x, km, *params, ctx.heads)
        gx, *gp = torch.autograd.grad(out, (x, *params), g)
        return (gx, None, *gp, None)


class _PostlnMlpTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wfc, bfc, wproj, bproj, act):
        out = fused_postln_mlp_block(x, ln_s, ln_b, wfc, bfc, wproj, bproj,
                                     act)
        ctx.save_for_backward(x, ln_s, ln_b, wfc, bfc, wproj, bproj)
        ctx.act = act
        return out

    @staticmethod
    def backward(ctx, g):
        args = _leaves(*ctx.saved_tensors)
        with torch.enable_grad():
            out = plain_postln_mlp_block(*args, ctx.act)
        return (*torch.autograd.grad(out, args, g), None)


def fused_postln_attn_block_train(x, km, ln_scale, ln_bias, wqkv, bqkv, wo,
                                  bo, heads: int):
    """fused_postln_attn_block for the XLM-R tower: under a gradient the same
    kernel forward and a recompute backward (``km`` gets none); with none
    the serve wrapper."""
    params = (ln_scale, ln_bias, wqkv, bqkv, wo, bo)
    if not _needs_grad(x, *params):
        return fused_postln_attn_block(x, km, *params, heads)
    return _PostlnAttnTrain.apply(x, km, *params, heads)


def fused_postln_mlp_block_train(x, ln_scale, ln_bias, wfc, bfc, wproj,
                                 bproj, act: str = "gelu"):
    """fused_postln_mlp_block for the XLM-R tower (the variant
    ``postln_mlp_choice`` picks): under a gradient the same forward and a
    recompute backward; with none the serve wrapper."""
    args = (x, ln_scale, ln_bias, wfc, bfc, wproj, bproj)
    if not _needs_grad(*args):
        return fused_postln_mlp_block(*args, act)
    return _PostlnMlpTrain.apply(*args, act)
