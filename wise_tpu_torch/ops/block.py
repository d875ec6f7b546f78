"""The CLIP towers' residual blocks: CUDA kernels and their plain versions.

Each wrapper keeps the JAX wrapper's signature and layout (wise_tpu/ops/
block.py): x (B, SP, D) in the stream dtype (f32 or bf16), weights bf16 in
x @ W layout (wqkv (D, 3D), wo (D, D), wfc (D, F), wproj (F, D)), biases bf16,
LayerNorm parameters f32. On a CPU tensor a wrapper computes its plain
version; on a CUDA tensor it launches its kernel chain
(csrc/block_kernels.cu) or raises. ``LAUNCHES`` counts the kernel launches.

| wrapper                       | TPU kernel it replaces                      |
| ----------------------------- | ------------------------------------------- |
| fused_attn_block              | fused_attn_block (block.py:466)             |
| fused_mlp_block               | fused_mlp_block (block.py:916)              |
| fused_attn_block_pooled       | fused_attn_block_pooled (block.py:634)      |
| fused_attn_block_pooled_dyn   | fused_attn_block_pooled_dyn (block.py:811)  |
"""

from __future__ import annotations

import math
import threading

import torch

from .build import check, load_library

EPS = 1e-5
HEAD_DIM = 64
MAX_SEQ = 128
ACTS = {"none": 0, "gelu": 1, "quick_gelu": 2, "gelu_tanh": 3}

#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = {
    "fused_attn_block": 0,
    "fused_mlp_block": 0,
    "fused_attn_block_pooled": 0,
    "fused_attn_block_pooled_dyn": 0,
}
#: the same launches keyed by (wrapper, SP, D) of x: one tower's count
LAUNCHES_BY_SHAPE: dict[tuple[str, int, int], int] = {}
_launch_lock = threading.Lock()  # request threads may launch concurrently


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        LAUNCHES_BY_SHAPE.clear()


def _counted(name: str, sp: int, d: int) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1
        key = (name, sp, d)
        LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def supports_fused_block(seq: int, width: int, heads: int) -> bool:
    """Static gate: the kernels take head_dim 64 and sequences up to 128."""
    return (width % heads == 0 and width // heads == HEAD_DIM
            and 1 <= seq <= MAX_SEQ)


# ---------------------------------------------------------------------------
# plain versions (the reference math of wise_tpu/ops/block.py plain_* and
# _pooled_block_xla*): f32 LayerNorm and softmax, GEMMs in the weight dtype,
# residual add in the stream dtype
# ---------------------------------------------------------------------------


def layer_norm_f32(x, scale, bias):
    """flax LayerNorm numerics in f32: var = max(E[x^2] - E[x]^2, 0)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return (xf - mean) * (torch.rsqrt(var + EPS) * scale) + bias


def activation(h, act: str):
    if act == "none":
        return h
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if act == "gelu_tanh":
        return torch.nn.functional.gelu(h, approximate="tanh")
    if act == "gelu":
        return torch.nn.functional.gelu(h)
    raise ValueError(f"unknown activation {act!r}")


def _softmax_attend(q, kh, vh, keep, dt):
    """q (B, [Q,] H, hd) against kh/vh (B, S, H, hd) under ``keep``."""
    hd = q.shape[-1]
    if q.dim() == 3:
        logits = torch.einsum("bhd,bkhd->bhk", q.float(), kh.float())
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh.float())
    logits = (logits * (1.0 / math.sqrt(hd))).masked_fill(~keep, -math.inf)
    p = torch.softmax(logits, dim=-1).to(dt)
    if q.dim() == 3:
        return torch.einsum("bhk,bkhd->bhd", p, vh)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh)


def plain_attn_block(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads: int,
                     n_valid: int, causal: bool = False):
    b, sp, d = x.shape
    hd = d // heads
    dt = wqkv.dtype
    y = layer_norm_f32(x, ln_s, ln_b).to(dt)
    q, k, v = (y @ wqkv + bqkv).split(d, dim=-1)
    col = torch.arange(sp, device=x.device)
    keep = (col < n_valid)[None, None, None, :]
    if causal:
        keep = keep & (col[None, :] <= col[:, None])[None, None]
    att = _softmax_attend(
        q.reshape(b, sp, heads, hd), k.reshape(b, sp, heads, hd),
        v.reshape(b, sp, heads, hd), keep, dt,
    ).reshape(b, sp, d)
    return x + (att @ wo + bo).to(x.dtype)


def plain_mlp_block(x, ln_s, ln_b, wfc, bfc, wproj, bproj, act: str = "gelu"):
    dt = wfc.dtype
    y = layer_norm_f32(x, ln_s, ln_b).to(dt)
    h = activation((y @ wfc + bfc).float(), act).to(dt)
    return x + (h @ wproj + bproj).to(x.dtype)


def plain_attn_block_pooled_dyn(x, rows, ln_s, ln_b, wqkv, bqkv, wo, bo,
                                heads: int, n_valid: int,
                                causal: bool = False):
    """The attention block's output at row ``rows[b]`` of each example,
    (B, D): k/v for every row, q and out-proj for the pooled one. Rows
    outside [0, SP) are clamped, as the kernel clamps them."""
    b, sp, d = x.shape
    hd = d // heads
    dt = wqkv.dtype
    y = layer_norm_f32(x, ln_s, ln_b).to(dt)
    kv = y @ wqkv[:, d:] + bqkv[d:]
    idx = rows.long().clamp(0, sp - 1)
    ar = torch.arange(b, device=x.device)
    q = y[ar, idx] @ wqkv[:, :d] + bqkv[:d]
    col = torch.arange(sp, device=x.device)[None, :]
    keep = col < n_valid
    if causal:
        keep = keep & (col <= idx[:, None])
    att = _softmax_attend(
        q.reshape(b, heads, hd), kv[..., :d].reshape(b, sp, heads, hd),
        kv[..., d:].reshape(b, sp, heads, hd), keep[:, None, :], dt,
    ).reshape(b, d)
    return x[ar, idx] + (att @ wo + bo).to(x.dtype)


def plain_attn_block_pooled(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads: int,
                            n_valid: int, pool_row: int = 0,
                            causal: bool = False):
    rows = torch.full((x.shape[0],), pool_row, dtype=torch.int32,
                      device=x.device)
    return plain_attn_block_pooled_dyn(x, rows, ln_s, ln_b, wqkv, bqkv, wo,
                                       bo, heads, n_valid, causal)


#: per-token cosine bar, the one tests/test_block_kernels.py holds the Pallas
#: kernels to (bf16 rounding points differ between orderings)
COS_MIN = 0.999
#: max abs error bound, as a share of the reference increment's max abs
ERR_SHARE = 0.05


def increment_agreement(got, want, base) -> dict:
    """How far a block's output ``got`` is from a reference ``want``,
    measured on the block's increment over its residual input ``base`` (x,
    or x at the pooled rows). The residual dominates a block's output, so a
    block that added nothing would still agree on the whole output.

    ok: finite, per-token cosine of the increments >= COS_MIN, and max abs
    error <= ERR_SHARE * max |want - base|."""
    base = base.float()
    a = (got.float() - base).reshape(-1, got.shape[-1])
    p = (want.float() - base).reshape(-1, want.shape[-1])
    err = (a - p).abs().max().item()
    bound = ERR_SHARE * p.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(a, p, dim=-1).min().item()
    ok = bool(torch.isfinite(a).all()) and cos >= COS_MIN and err <= bound
    return dict(max_abs_err=err, err_bound=bound, min_cos=cos, ok=ok)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _is_f32(x) -> int:
    return int(x.dtype == torch.float32)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_x(x, name: str):
    _require(x.dim() == 3 and x.is_contiguous(),
             f"{name}: x must be a contiguous (B, SP, D) tensor")
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"{name}: x dtype {x.dtype} not in (float32, bfloat16)")
    b, sp, d = x.shape
    _require(b >= 1 and 1 <= sp <= MAX_SEQ,
             f"{name}: batch {b} / sequence {sp} outside [1, {MAX_SEQ}]")
    _require(d % HEAD_DIM == 0, f"{name}: width {d} not a multiple of 64")
    return b, sp, d


def _check_param(t, shape, dtype, device, name):
    _require(tuple(t.shape) == tuple(shape),
             f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    _require(t.dtype == dtype, f"{name}: dtype {t.dtype} != {dtype}")
    _require(t.device == device and t.is_contiguous(),
             f"{name}: must be contiguous on {device}")


def _check_attn(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, n_valid, name):
    b, sp, d = _check_x(x, name)
    _require(heads >= 1 and d == heads * HEAD_DIM,
             f"{name}: head_dim {d // max(heads, 1)} != {HEAD_DIM}")
    _require(1 <= n_valid <= sp, f"{name}: n_valid {n_valid} not in [1, {sp}]")
    dev, bf = x.device, torch.bfloat16
    _check_param(ln_s, (d,), torch.float32, dev, f"{name} ln_scale")
    _check_param(ln_b, (d,), torch.float32, dev, f"{name} ln_bias")
    _check_param(wqkv, (d, 3 * d), bf, dev, f"{name} wqkv")
    _check_param(bqkv, (3 * d,), bf, dev, f"{name} bqkv")
    _check_param(wo, (d, d), bf, dev, f"{name} wo")
    _check_param(bo, (d,), bf, dev, f"{name} bo")
    return b, sp, d


def fused_attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads: int,
                     n_valid: int, causal: bool = False):
    """x (B, SP, D) -> x + out_proj(MHA(LN(x))); key columns >= n_valid are
    masked, ``causal`` also masks columns above the query row."""
    if not x.is_cuda:
        return plain_attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                heads, n_valid, causal)
    name = "fused_attn_block"
    b, sp, d = _check_attn(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads,
                           n_valid, name)
    lib = load_library()
    m = b * sp
    scratch = dict(dtype=torch.bfloat16, device=x.device)
    y = torch.empty((m, d), **scratch)
    qkv = torch.empty((m, 3 * d), **scratch)
    att = torch.empty((m, d), **scratch)
    out = torch.empty_like(x)
    check(lib.wt_attn_block(
        *_ptrs(x), _is_f32(x), *_ptrs(ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                     out, y, qkv, att),
        b, sp, d, heads, int(n_valid), int(causal), _stream(x)), name)
    _counted(name, sp, d)
    return out


def fused_mlp_block(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj,
                    act: str = "gelu"):
    """x (B, SP, D) -> x + proj(act(fc(LN(x))))."""
    if not x.is_cuda:
        return plain_mlp_block(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj,
                               act)
    name = "fused_mlp_block"
    _require(act in ACTS, f"{name}: unknown activation {act!r}")
    b, sp, d = _check_x(x, name)
    f = wfc.shape[-1]
    _require(f % 128 == 0, f"{name}: hidden width {f} not a multiple of 128")
    dev, bf = x.device, torch.bfloat16
    _check_param(ln_scale, (d,), torch.float32, dev, f"{name} ln_scale")
    _check_param(ln_bias, (d,), torch.float32, dev, f"{name} ln_bias")
    _check_param(wfc, (d, f), bf, dev, f"{name} wfc")
    _check_param(bfc, (f,), bf, dev, f"{name} bfc")
    _check_param(wproj, (f, d), bf, dev, f"{name} wproj")
    _check_param(bproj, (d,), bf, dev, f"{name} bproj")
    lib = load_library()
    m = b * sp
    y = torch.empty((m, d), dtype=bf, device=dev)
    h = torch.empty((m, f), dtype=bf, device=dev)
    out = torch.empty_like(x)
    check(lib.wt_mlp_block(
        *_ptrs(x), _is_f32(x), *_ptrs(ln_scale, ln_bias, wfc, bfc, wproj,
                                     bproj, out, y, h),
        m, d, f, ACTS[act], _stream(x)), name)
    _counted(name, sp, d)
    return out


def _pooled_launch(name, x, rows, pool_row, ln_scale, ln_bias, wqkv, bqkv, wo,
                   bo, heads, n_valid, causal):
    b, sp, d = _check_attn(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads,
                           n_valid, name)
    lib = load_library()
    bf = torch.bfloat16
    y = torch.empty((b * sp, d), dtype=bf, device=x.device)
    kv = torch.empty((b * sp, 2 * d), dtype=bf, device=x.device)
    q = torch.empty((b, d), dtype=bf, device=x.device)
    att = torch.empty((b, d), dtype=bf, device=x.device)
    out = torch.empty((b, d), dtype=x.dtype, device=x.device)
    check(lib.wt_attn_block_pooled(
        *_ptrs(x), _is_f32(x), *_ptrs(ln_scale, ln_bias, wqkv, bqkv, wo, bo),
        None if rows is None else rows.data_ptr(), int(pool_row),
        *_ptrs(out, y, kv, q, att), b, sp, d, heads, int(n_valid),
        int(causal), _stream(x)), name)
    _counted(name, sp, d)
    return out


def fused_attn_block_pooled(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                            heads: int, n_valid: int, pool_row: int = 0,
                            causal: bool = False):
    """x (B, SP, D) -> (x + out_proj(MHA(LN(x))))[:, pool_row] as (B, D)."""
    if not x.is_cuda:
        return plain_attn_block_pooled(x, ln_scale, ln_bias, wqkv, bqkv, wo,
                                       bo, heads, n_valid, pool_row, causal)
    _require(0 <= pool_row < x.shape[1],
             f"fused_attn_block_pooled: pool_row {pool_row} out of range")
    return _pooled_launch("fused_attn_block_pooled", x, None, pool_row,
                          ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads,
                          n_valid, causal)


def fused_attn_block_pooled_dyn(x, rows, ln_scale, ln_bias, wqkv, bqkv, wo,
                                bo, heads: int, n_valid: int,
                                causal: bool = False):
    """x (B, SP, D), rows (B,) int32 -> the attention block's output at
    each example's own row (clamped into [0, SP)), (B, D); causal masks
    columns > rows[b]. Takes every batch size."""
    if not x.is_cuda:
        return plain_attn_block_pooled_dyn(x, rows, ln_scale, ln_bias, wqkv,
                                           bqkv, wo, bo, heads, n_valid,
                                           causal)
    name = "fused_attn_block_pooled_dyn"
    _check_param(rows, (x.shape[0],), torch.int32, x.device, f"{name} rows")
    return _pooled_launch(name, x, rows, 0, ln_scale, ln_bias, wqkv, bqkv, wo,
                          bo, heads, n_valid, causal)
