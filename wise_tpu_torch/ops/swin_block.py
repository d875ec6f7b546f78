"""The whole Swin block (CLAP's HTSAT): the CUDA kernel and its plain version.

| wrapper          | TPU kernel it replaces                  |
| ---------------- | --------------------------------------- |
| fused_swin_block | fused_swin_block (swin_block.py:227)    |

The wrapper keeps the JAX wrapper's signature and layout
(wise_tpu/ops/swin_block.py): x (N, L, C) bf16 window batch (raw, pre-LN),
LayerNorm parameters f32, weights in x @ W layout with biases in the weight
dtype, the relative-position bias (heads, L, L) f32 and the shift mask
(n_win, L, L) f32 or None. On a CPU tensor it computes its plain version; on
a CUDA tensor it launches ``wt_swin_block`` (csrc/swin_kernels.cu) or raises.
The TPU wrapper's window-group pickers (VMEM budgets, calibration tables)
have no counterpart: the kernel takes every window batch.
"""

from __future__ import annotations

import torch

from .block import (_check_param, _ptrs, _require, _stream, activation,
                    layer_norm_f32)
from .build import LaunchCounter, check, load_library
from .swin_attention import (check_dense, check_window_inputs,
                             plain_window_attention)

_launches = LaunchCounter("fused_swin_block")
#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = _launches.counts
#: the same launches keyed by (wrapper, L, C, masked): one stage's count,
#: shifted blocks (with a shift mask) apart from the others
LAUNCHES_BY_SHAPE = _launches.by_shape
reset_launches = _launches.reset


def plain_swin_block(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, bias, mask,
                     ln2_scale, ln2_bias, wfc, bfc, wproj, bproj, heads: int):
    """o = x + out_proj(WindowMHA(LN1 x) + bias [+ mask]);
    out = o + fc2(gelu(fc1(LN2 o))): f32 LayerNorms, softmax and GELU, GEMMs
    in the weight dtype, residual adds in x's dtype."""
    dt = wqkv.dtype
    y = layer_norm_f32(x, ln1_scale, ln1_bias).to(dt)
    o = x + plain_window_attention(y, wqkv, bqkv, wo, bo, bias, mask,
                                   heads).to(x.dtype)
    y = layer_norm_f32(o, ln2_scale, ln2_bias).to(dt)
    h = activation((y @ wfc + bfc).float(), "gelu").to(dt)
    return o + (h @ wproj + bproj).to(x.dtype)


def fused_swin_block(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, bias, mask,
                     ln2_scale, ln2_bias, wfc, bfc, wproj, bproj,
                     heads: int):
    """x (N, L, C) -> the Swin block's output on the same windows."""
    if not x.is_cuda:
        return plain_swin_block(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo,
                                bias, mask, ln2_scale, ln2_bias, wfc, bfc,
                                wproj, bproj, heads)
    name = "fused_swin_block"
    n, l, c, n_win = check_window_inputs(x, bias, mask, heads, name)
    f = wfc.shape[-1]
    dev = x.device
    for s, b, tag in ((ln1_scale, ln1_bias, "ln1"), (ln2_scale, ln2_bias,
                                                      "ln2")):
        _check_param(s, (c,), torch.float32, dev, f"{name} {tag}_scale")
        _check_param(b, (c,), torch.float32, dev, f"{name} {tag}_bias")
    check_dense(wqkv, bqkv, (c, 3 * c), dev, f"{name} qkv")
    check_dense(wo, bo, (c, c), dev, f"{name} proj")
    check_dense(wfc, bfc, (c, f), dev, f"{name} fc1")
    check_dense(wproj, bproj, (f, c), dev, f"{name} fc2")
    _require(f % 32 == 0, f"{name}: hidden width {f} not a multiple of 32")
    lib = load_library()
    m = n * l
    scratch = dict(dtype=torch.bfloat16, device=dev)
    y = torch.empty((m, c), **scratch)
    qkv = torch.empty((m, 3 * c), **scratch)
    att = torch.empty((m, c), **scratch)
    o = torch.empty((m, c), **scratch)
    h = torch.empty((m, f), **scratch)
    out = torch.empty_like(x)
    check(lib.wt_swin_block(
        *_ptrs(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, bias),
        None if mask is None else mask.data_ptr(), n_win,
        *_ptrs(ln2_scale, ln2_bias, wfc, bfc, wproj, bproj, out, y, qkv, att,
               o, h),
        n, l, c, heads, f, _stream(x)), name)
    _launches.add(name, l, c, n_win > 0)
    return out
