"""Swin window attention (CLAP's HTSAT): the CUDA kernel and its plain version.

| wrapper                | TPU kernel it replaces                          |
| ---------------------- | ----------------------------------------------- |
| fused_window_attention | fused_window_attention (swin_attention.py:129)  |

The wrapper keeps the JAX wrapper's signature and layout
(wise_tpu/ops/swin_attention.py): x (N, L, C) window batch, weights in x @ W
layout (wqkv (C, 3C), wo (C, C)) with biases in the weight dtype, the
relative-position bias (heads, L, L) f32 and the shift mask (n_win, L, L) f32
or None, window w taking mask[w % n_win]. On a CPU tensor it computes its
plain version; on a CUDA tensor it launches ``wt_window_attention``
(csrc/swin_kernels.cu) or raises. ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import math

import torch

from .block import _check_param, _ptrs, _require, _stream
from .build import LaunchCounter, check, load_library

MAX_WINDOW_TOKENS = 64
MAX_HEAD_DIM = 32

_launches = LaunchCounter("fused_window_attention")
#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = _launches.counts
#: the same launches keyed by (wrapper, L, C, masked): one stage's count,
#: shifted blocks (with a shift mask) apart from the others
LAUNCHES_BY_SHAPE = _launches.by_shape
reset_launches = _launches.reset


def supports_swin_kernels(seq: int, width: int, heads: int) -> bool:
    """The shapes both Swin kernels take: windows of at most 64 tokens,
    head_dim a multiple of 8 up to 32, and C a multiple of 32 (a GEMM
    depth)."""
    hd = width // heads if heads else 0
    return (heads >= 1 and hd * heads == width and hd % 8 == 0
            and hd <= MAX_HEAD_DIM and 1 <= seq <= MAX_WINDOW_TOKENS
            and width % 32 == 0)


def plain_window_attention(x, wqkv, bqkv, wo, bo, bias, mask, heads: int):
    """out_proj(softmax(QK^T / sqrt(hd) + bias [+ mask]) V): f32 logits and
    softmax, GEMMs in the weight dtype, output in the weight dtype."""
    n, l, c = x.shape
    hd = c // heads
    dt = wqkv.dtype
    qkv = x.to(dt) @ wqkv + bqkv
    q, k, v = qkv.reshape(n, l, 3, heads, hd).permute(2, 0, 3, 1, 4)
    logits = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    logits = logits + bias
    if mask is not None:
        n_win = mask.shape[0]
        logits = (logits.reshape(n // n_win, n_win, heads, l, l)
                  + mask[None, :, None]).reshape(n, heads, l, l)
    p = torch.softmax(logits, dim=-1).to(dt)
    att = (p @ v).transpose(1, 2).reshape(n, l, c)
    return att @ wo + bo


def check_window_inputs(x, bias, mask, heads: int, name: str):
    """The checks both Swin wrappers make on x, the bias and the mask:
    returns (N, L, C, n_win), n_win 0 without a mask."""
    _require(x.dim() == 3 and x.is_contiguous(),
             f"{name}: x must be a contiguous (N, L, C) tensor")
    _require(x.dtype == torch.bfloat16,
             f"{name}: x dtype {x.dtype} != torch.bfloat16")
    n, l, c = x.shape
    _require(n >= 1 and supports_swin_kernels(l, c, heads),
             f"{name}: window batch {n} x {l} x {c} with {heads} heads is "
             f"outside the kernel's shapes (L <= {MAX_WINDOW_TOKENS}, "
             f"head_dim % 8 == 0 and <= {MAX_HEAD_DIM}, C % 32 == 0)")
    _check_param(bias, (heads, l, l), torch.float32, x.device,
                 f"{name} bias")
    n_win = 0
    if mask is not None:
        n_win = mask.shape[0]
        _check_param(mask, (n_win, l, l), torch.float32, x.device,
                     f"{name} mask")
        _require(n_win >= 1 and n % n_win == 0,
                 f"{name}: window batch {n} not a multiple of the mask's "
                 f"{n_win} windows")
    return n, l, c, n_win


def check_dense(w, b, shape, device, name: str) -> None:
    _check_param(w, shape, torch.bfloat16, device, f"{name} kernel")
    _check_param(b, shape[1:], torch.bfloat16, device, f"{name} bias")


def fused_window_attention(x, wqkv, bqkv, wo, bo, bias, mask, heads: int):
    """x (N, L, C) -> out_proj(WindowMHA(x) + bias [+ mask]), (N, L, C)."""
    if not x.is_cuda:
        return plain_window_attention(x, wqkv, bqkv, wo, bo, bias, mask,
                                      heads)
    name = "fused_window_attention"
    n, l, c, n_win = check_window_inputs(x, bias, mask, heads, name)
    check_dense(wqkv, bqkv, (c, 3 * c), x.device, f"{name} qkv")
    check_dense(wo, bo, (c, c), x.device, f"{name} proj")
    lib = load_library()
    m = n * l
    scratch = dict(dtype=torch.bfloat16, device=x.device)
    qkv = torch.empty((m, 3 * c), **scratch)
    att = torch.empty((m, c), **scratch)
    out = torch.empty_like(x)
    check(lib.wt_window_attention(
        *_ptrs(x, wqkv, bqkv, wo, bo, bias),
        None if mask is None else mask.data_ptr(), n_win,
        *_ptrs(out, qkv, att), n, l, c, heads, _stream(x)), name)
    _launches.add(name, l, c, n_win > 0)
    return out
