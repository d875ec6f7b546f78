"""The whole Swin block (CLAP's HTSAT): the CUDA kernels and their plain version.

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
have no counterpart: the kernels take every window batch.

``token_map=`` (a keyword the JAX wrapper lacks; the same function) moves
the shift's roll and the window partition into the kernel: x and the output
are then spatial rows (B·H·W, C), in any shape with C last, and
``token_map`` (H·W,) int32 gives, for window-layout row r of an image, its
spatial row (``token_map``, the function). The kernel reads x's rows and
writes the output's through it, so the caller makes no roll, partition or
reverse copies. Up to the C entry's ``kSwinFusedMaxC``
(ops/swin_attention.py ``swin_route``) the block is two kernels,
``swin_attn_kernel`` and ``swin_mlp_kernel``; wider (HTSAT's stage 3) it
is the chain of seven, on window layout only, and takes no map: one 8 x 8
window covers stage 3's whole map, so no caller has one there.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .block import (_check_param, _ptrs, _require, _stream, activation,
                    layer_norm_f32)
from .build import LaunchCounter, check, load_library, refuse_grad
from .swin_attention import (_kernels, check_dense, check_window_inputs,
                             count_launched, launched_array,
                             plain_window_attention, swin_route)

_launches = LaunchCounter("fused_swin_block")
#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = _launches.counts
#: the same launches keyed by (wrapper, L, C, masked): one stage's count,
#: shifted blocks (with a shift mask) apart from the others
LAUNCHES_BY_SHAPE = _launches.by_shape


def reset_launches() -> None:
    _launches.reset()
    _kernels.reset()


def token_map(hres: int, wres: int, window: int, shift: int) -> torch.Tensor:
    """(hres·wres,) int32 on the CPU: for window-layout row r of an image
    (the roll by -shift over both spatial axes, then the window partition),
    its spatial row. The same index ops applied to an arange; the reverse
    partition and the roll back are its inverse permutation."""
    idx = np.arange(hres * wres, dtype=np.int32).reshape(hres, wres)
    if shift:
        idx = np.roll(idx, (-shift, -shift), axis=(0, 1))
    idx = idx.reshape(hres // window, window, wres // window, window)
    return torch.from_numpy(np.ascontiguousarray(
        idx.transpose(0, 2, 1, 3).reshape(-1)))


def _map_rows(tmap, rows: int, device) -> torch.Tensor:
    """Every window-layout row's spatial row over ``rows`` tokens: image b's
    rows b·H·W + tmap."""
    hw = tmap.numel()
    base = torch.arange(0, rows, hw, device=device)
    return (base[:, None] + tmap.to(device).long()[None]).reshape(-1)


def plain_swin_block(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, bias, mask,
                     ln2_scale, ln2_bias, wfc, bfc, wproj, bproj, heads: int,
                     token_map=None):
    """o = x + out_proj(WindowMHA(LN1 x) + bias [+ mask]);
    out = o + fc2(gelu(fc1(LN2 o))): f32 LayerNorms, softmax and GELU, GEMMs
    in the weight dtype, residual adds in x's dtype. With ``token_map`` it
    gathers x's rows into window layout, runs the block and scatters the
    rows back."""
    if token_map is not None:
        l, c = bias.shape[-1], x.shape[-1]
        rows = _map_rows(token_map, x.numel() // c, x.device)
        xw = x.reshape(-1, c)[rows].reshape(-1, l, c)
        yw = plain_swin_block(xw, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo,
                              bias, mask, ln2_scale, ln2_bias, wfc, bfc,
                              wproj, bproj, heads)
        out = torch.empty_like(x).reshape(-1, c)
        out[rows] = yw.reshape(-1, c)
        return out.reshape(x.shape)
    dt = wqkv.dtype
    y = layer_norm_f32(x, ln1_scale, ln1_bias).to(dt)
    o = x + plain_window_attention(y, wqkv, bqkv, wo, bo, bias, mask,
                                   heads).to(x.dtype)
    y = layer_norm_f32(o, ln2_scale, ln2_bias).to(dt)
    h = activation((y @ wfc + bfc).float(), "gelu").to(dt)
    return o + (h @ wproj + bproj).to(x.dtype)


def fused_swin_block(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, bias, mask,
                     ln2_scale, ln2_bias, wfc, bfc, wproj, bproj,
                     heads: int, token_map=None):
    """x (N, L, C) -> the Swin block's output on the same windows; with
    ``token_map``, x spatial rows (..., C) -> the output in x's shape."""
    if not x.is_cuda:
        return plain_swin_block(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo,
                                bias, mask, ln2_scale, ln2_bias, wfc, bfc,
                                wproj, bproj, heads, token_map=token_map)
    name = "fused_swin_block"
    refuse_grad(name, (x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, bias,
                       ln2_scale, ln2_bias, wfc, bfc, wproj, bproj),
                "the reference has no training rule for it either")
    xw, hw = x, 0
    if token_map is not None:
        _require(x.dim() >= 2 and x.is_contiguous() and bias.dim() == 3,
                 f"{name}: under token_map x must be contiguous spatial rows "
                 f"(..., C) and bias (heads, L, L)")
        hw, l, c = token_map.numel(), bias.shape[-1], x.shape[-1]
        _check_param(token_map, (hw,), torch.int32, x.device,
                     f"{name} token_map")
        _require(l >= 1 and hw % l == 0 and x.numel() % (hw * c) == 0,
                 f"{name}: {x.numel() // max(c, 1)} rows are not whole "
                 f"images of the map's {hw} tokens in windows of {l}")
        xw = x.reshape(-1, l, c)
    n, l, c, n_win = check_window_inputs(xw, bias, mask, heads, name)
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
    route = swin_route(c)
    _require(token_map is None or route == "fused",
             f"{name}: C {c} runs the chain, which takes no token_map")

    def scratch(width):
        return torch.empty((m, width), dtype=torch.bfloat16, device=dev)

    # o (M, C): kernel A's output, kernel B's input; the chain's y, qkv,
    # att and h besides
    bufs = [scratch(c)]
    if route == "chain":
        bufs += [scratch(c), scratch(3 * c), scratch(c), scratch(f)]
    o, y, qkv, att, h = _ptrs(*bufs) + [None] * (5 - len(bufs))
    out = torch.empty_like(x)
    launched = launched_array()
    check(lib.wt_swin_block(
        xw.data_ptr(), None if token_map is None else token_map.data_ptr(),
        hw, *_ptrs(ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, bias),
        None if mask is None else mask.data_ptr(), n_win,
        *_ptrs(ln2_scale, ln2_bias, wfc, bfc, wproj, bproj, out),
        o, y, qkv, att, h, n, l, c, heads, f, ctypes.addressof(launched),
        _stream(x)), name)
    _launches.add(name, l, c, n_win > 0)
    count_launched(launched, l, c, n_win > 0)
    return out
