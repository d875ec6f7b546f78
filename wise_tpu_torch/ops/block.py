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
| fused_mlp_split (fused_mlp_fc | fused_mlp_split (block.py:1209: _fc_kernel  |
|   then fused_mlp_proj)        |   block.py:1129, _proj_kernel block.py:1158)|
| fused_attn_block_res          | fused_attn_block_res (block.py:1586)        |
| fused_mlp_block_res           | fused_mlp_block_res (block.py:1635)         |
| fused_mlp_split_res           | fused_mlp_split_res (block.py:1681)         |
| fused_ln_matmul               | fused_ln_matmul (block.py:1303)             |
| fused_residual_matmul         | fused_residual_matmul (block.py:1340)       |

The head-split forms (tensor parallelism, ``--mp``) run the same kernels
at a rank's H/mp heads and F/mp columns and end in an f32 partial that
``mp_close`` sums over the ranks: ``fused_attn_partial``,
``fused_attn_pooled_partial`` and ``fused_mlp_partial`` (the fc / proj pair),
with their ``*_mp_train`` rules and ``plain_*_mp`` twins (the section below).

``fused_attn_block_padded`` (block.py:1420) chains the last two with the
attention middle (ops/attention.py) at head_dim 128: the padded-head block
for head dims that are not a multiple of 64, with its training rule
``fused_attn_block_padded_train`` (block.py:1931). Its gate
``supports_fused_block_padded`` reads a table that is empty, as the
reference's is, so no tower takes it unless a caller fills the table.

The ``*_res`` wrappers are the training forwards: each returns its serve
twin's output and the residual the backward starts from (the post-bias qkv,
the pre-activation fc output), in the weight dtype. The ``*_train`` functions
(wise_tpu/ops/block.py:1906-2045) are what the towers call: with no gradient
required they are the serve wrappers; otherwise a ``torch.autograd.Function``
whose forward launches the ``*_res`` kernel (the pooled ones their serve
kernel) and whose backward is plain PyTorch, as the reference's is plain JAX.
Any other wrapper called on the card under autograd with an input that
requires a gradient raises: a kernel writes through raw pointers, and its
output would be cut from the graph.
"""

from __future__ import annotations

import math

import torch

from .build import LaunchCounter, check, load_library, refuse_grad

EPS = 1e-5
#: head dims the attention kernels are instantiated for (csrc/attention.cuh,
#: csrc/block_kernels.cu): 64, 80 (ViT-H/14), 88 (ViT-g-14), 104 (ViT-bigG-14)
HEAD_DIMS = (64, 80, 88, 104)
#: longest sequence the attention kernels take (csrc/attention.cuh kMaxSeq,
#: kept equal): ten 64-key tiles, for the 576 tokens of SigLIP at 384 px and
#: the 577 of ViT-L/14 at 336 px. Not a shared-memory limit (the kernel's key
#: loop holds 64 keys at a time, the pooled kernel SP floats of logits)
MAX_SEQ = 640
ACTS = {"none": 0, "gelu": 1, "quick_gelu": 2, "gelu_tanh": 3}

_launches = LaunchCounter("fused_attn_block", "fused_mlp_block",
                          "fused_attn_block_pooled",
                          "fused_attn_block_pooled_dyn", "fused_mlp_fc",
                          "fused_mlp_proj", "fused_attn_block_res",
                          "fused_mlp_block_res", "fused_mlp_fc_res",
                          "fused_ln_matmul", "fused_residual_matmul",
                          "pooled_attention", "fused_attn_block_mp",
                          "fused_mlp_fc_mp", "fused_mlp_proj_mp",
                          "fused_attn_block_pooled_mp",
                          "fused_attn_block_pooled_dyn_mp")
#: kernel launches per wrapper since the last reset_launches()
LAUNCHES = _launches.counts
#: the same launches keyed by (wrapper, SP, D) of x: one tower's count
LAUNCHES_BY_SHAPE = _launches.by_shape
reset_launches = _launches.reset


def supports_fused_block(seq: int, width: int, heads: int) -> bool:
    """Whether the kernels take the shape: a head_dim in HEAD_DIMS and
    sequences up to MAX_SEQ. A predicate for callers that want to ask first;
    the wrappers check for themselves and raise on the card."""
    return (heads >= 1 and width % heads == 0
            and width // heads in HEAD_DIMS and 1 <= seq <= MAX_SEQ)


def mlp_choice(width: int) -> str:
    """Which MLP wrapper a tower of this width takes: "single"
    (fused_mlp_block) up to width 768, "split" (fused_mlp_split) above. The
    rule only mirrors the reference's calibration table
    (wise_tpu/ops/block.py:103-114), where the split exists because both
    weights do not fit VMEM. Here both wrappers run the same LayerNorm and
    GEMM chain and differ in who owns h, so the choice costs nothing."""
    return "single" if width <= 768 else "split"


# ---------------------------------------------------------------------------
# plain versions (the reference math of wise_tpu/ops/block.py plain_* and
# _pooled_block_xla*): f32 LayerNorm and softmax, GEMMs in the weight dtype,
# residual add in the stream dtype
# ---------------------------------------------------------------------------


def layer_norm_f32(x, scale, bias, eps: float = EPS):
    """flax LayerNorm numerics in f32: var = max(E[x^2] - E[x]^2, 0)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return (xf - mean) * (torch.rsqrt(var + eps) * scale) + bias


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


def qkv_stage(x, ln_s, ln_b, wqkv, bqkv):
    """The attention block up to its cut point: the post-bias in-projection
    of LN(x), (B, SP, 3D) in the weight dtype (wise_tpu/ops/block.py:1813
    ``_qkv_stage``)."""
    return layer_norm_f32(x, ln_s, ln_b).to(wqkv.dtype) @ wqkv + bqkv


def attention_of_qkv(qkv, heads: int, n_valid: int, causal: bool = False):
    """Multi-head attention on a packed in-projection qkv (B, SP, 3D):
    (B, SP, D) in qkv's dtype, f32 logits and softmax."""
    b, sp, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    q, k, v = qkv.split(d, dim=-1)
    col = torch.arange(sp, device=qkv.device)
    keep = (col < n_valid)[None, None, None, :]
    if causal:
        keep = keep & (col[None, :] <= col[:, None])[None, None]
    return _softmax_attend(
        q.reshape(b, sp, heads, hd), k.reshape(b, sp, heads, hd),
        v.reshape(b, sp, heads, hd), keep, qkv.dtype,
    ).reshape(b, sp, d)


def attn_from_qkv(x, qkv, wo, bo, heads: int, n_valid: int,
                  causal: bool = False):
    """The attention block from its cut point: x + out_proj(MHA(qkv))
    (wise_tpu/ops/block.py:1818 ``_attn_from_qkv``)."""
    att = attention_of_qkv(qkv, heads, n_valid, causal)
    return x + (att @ wo + bo).to(x.dtype)


def fc_stage(x, ln_s, ln_b, wfc, bfc):
    """The MLP block up to its cut point: the pre-activation fc output of
    LN(x), (B, SP, F) in the weight dtype (wise_tpu/ops/block.py:1839
    ``_fc_stage``)."""
    return layer_norm_f32(x, ln_s, ln_b).to(wfc.dtype) @ wfc + bfc


def mlp_from_h(x, h_pre, wproj, bproj, act: str = "gelu"):
    """The MLP block from its cut point: x + proj(act(h_pre)), the
    activation in f32 on the rounded h_pre (wise_tpu/ops/block.py:1844
    ``_mlp_from_h``)."""
    h = activation(h_pre.float(), act).to(h_pre.dtype)
    return plain_mlp_proj(h, wproj, bproj, x)


def plain_attn_block_res(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads: int,
                         n_valid: int, causal: bool = False):
    """(x + out_proj(MHA(LN(x))), the post-bias qkv (B, SP, 3D))."""
    qkv = qkv_stage(x, ln_s, ln_b, wqkv, bqkv)
    return attn_from_qkv(x, qkv, wo, bo, heads, n_valid, causal), qkv


def plain_attn_block(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads: int,
                     n_valid: int, causal: bool = False):
    return plain_attn_block_res(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads,
                                n_valid, causal)[0]


def plain_mlp_block_res(x, ln_s, ln_b, wfc, bfc, wproj, bproj,
                        act: str = "gelu"):
    """(x + proj(act(fc(LN(x)))), the pre-activation fc output (B, SP, F))."""
    h_pre = fc_stage(x, ln_s, ln_b, wfc, bfc)
    return mlp_from_h(x, h_pre, wproj, bproj, act), h_pre


def plain_mlp_split_res(x, ln_s, ln_b, wfc, bfc, wproj, bproj,
                        act: str = "gelu"):
    return plain_mlp_block_res(x, ln_s, ln_b, wfc, bfc, wproj, bproj, act)


def plain_mlp_block(x, ln_s, ln_b, wfc, bfc, wproj, bproj, act: str = "gelu"):
    return plain_mlp_split(x, ln_s, ln_b, wfc, bfc, wproj, bproj, act)


def plain_mlp_fc_res(x, ln_s, ln_b, wfc, bfc, act: str = "gelu"):
    """(h = act(fc(LN(x))), the pre-activation fc(LN(x))), both (B, SP, F)
    in the weight dtype."""
    h_pre = fc_stage(x, ln_s, ln_b, wfc, bfc)
    return activation(h_pre.float(), act).to(h_pre.dtype), h_pre


def plain_mlp_fc(x, ln_s, ln_b, wfc, bfc, act: str = "gelu"):
    """h = act(fc(LN(x))) in the weight dtype, (B, SP, F)."""
    return plain_mlp_fc_res(x, ln_s, ln_b, wfc, bfc, act)[0]


def plain_mlp_proj(h, wproj, bproj, x):
    """x + (proj(h) + b) in x's dtype."""
    return x + (h @ wproj + bproj).to(x.dtype)


def plain_mlp_split(x, ln_s, ln_b, wfc, bfc, wproj, bproj, act: str = "gelu"):
    return plain_mlp_proj(plain_mlp_fc(x, ln_s, ln_b, wfc, bfc, act), wproj,
                          bproj, x)


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
    att = plain_pooled_attention(q, kv.reshape(b, sp, 2 * d), heads, n_valid,
                                 idx, causal=causal)
    return x[ar, idx] + (att @ wo + bo).to(x.dtype)


def plain_pooled_attention(q, kv, heads: int, n_valid: int, rows=None,
                           pool_row: int = 0, causal: bool = False):
    """The pooled blocks' attention: q (B, D) at each example's row
    (``rows`` (B,), clamped into [0, SP), or ``pool_row``) against
    kv (B, SP, 2D) rows [k | v] -> (B, D) in q's dtype. Keys >= n_valid
    and, with causal, keys past the row are dropped; f32 logits and
    softmax, p rounded to q's dtype before P V."""
    b, sp, d2 = kv.shape
    d = d2 // 2
    hd = d // heads
    col = torch.arange(sp, device=q.device)[None, :]
    if rows is None:
        rows = torch.full((b,), pool_row, device=q.device)
    keep = col < n_valid
    if causal:
        keep = keep & (col <= rows.long().clamp(0, sp - 1)[:, None])
    return _softmax_attend(
        q.reshape(b, heads, hd), kv[..., :d].reshape(b, sp, heads, hd),
        kv[..., d:].reshape(b, sp, heads, hd), keep[:, None, :], q.dtype,
    ).reshape(b, d)


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


#: max abs error bound of a whole output, in bf16 ulps of the reference's max
#: abs (the kernels read 1 ulp against their plain versions: one side rounds
#: up, the other down)
OUT_ULPS = 4


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 values (8 significand bits) at magnitude ``v``."""
    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 0.0


def output_agreement(got, want) -> dict:
    """How far an op's whole output ``got`` is from a reference ``want``:
    the yardstick for ops without a residual stream under their output (a
    post-LN block's output is a LayerNorm's, the attention middle's is the
    attention alone), where ``increment_agreement`` has no base to take off.
    An output of unit variance leaves 5% of its max abs far too wide (half a
    typical value), so the error is held to bf16's own spacing instead.

    ok: finite, per-token cosine >= COS_MIN, and max abs error <= OUT_ULPS
    bf16 ulps of max |want|."""
    a = got.float().reshape(-1, got.shape[-1])
    p = want.float().reshape(-1, want.shape[-1])
    err = (a - p).abs().max().item()
    bound = OUT_ULPS * bf16_ulp(p.abs().max().item())
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


def _refuse_grad(name: str, train: str, *tensors) -> None:
    refuse_grad(name, tensors, f"call {train}, which differentiates")


def _check_x(x, name: str):
    _require(x.dim() == 3 and x.is_contiguous(),
             f"{name}: x must be a contiguous (B, SP, D) tensor")
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"{name}: x dtype {x.dtype} not in (float32, bfloat16)")
    b, sp, d = x.shape
    _require(b >= 1 and 1 <= sp <= MAX_SEQ,
             f"{name}: batch {b} / sequence {sp} outside [1, {MAX_SEQ}]")
    _require(d % 32 == 0, f"{name}: width {d} not a multiple of 32")
    return b, sp, d


def _check_param(t, shape, dtype, device, name):
    _require(tuple(t.shape) == tuple(shape),
             f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    _require(t.dtype == dtype, f"{name}: dtype {t.dtype} != {dtype}")
    _require(t.device == device and t.is_contiguous(),
             f"{name}: must be contiguous on {device}")
    # a matrix may be a GEMM operand, which TMA loads from 16-byte-aligned
    # addresses (csrc/common.cuh)
    _require(t.dim() < 2 or t.data_ptr() % 16 == 0,
             f"{name}: must start on a 16-byte boundary")


def _check_attn(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, n_valid, name):
    b, sp, d = _check_x(x, name)
    _require(heads >= 1 and d % heads == 0 and d // heads in HEAD_DIMS,
             f"{name}: head_dim {d / max(heads, 1):g} not in {HEAD_DIMS}")
    _require(1 <= n_valid <= sp, f"{name}: n_valid {n_valid} not in [1, {sp}]")
    dev, bf = x.device, torch.bfloat16
    _check_param(ln_s, (d,), torch.float32, dev, f"{name} ln_scale")
    _check_param(ln_b, (d,), torch.float32, dev, f"{name} ln_bias")
    _check_param(wqkv, (d, 3 * d), bf, dev, f"{name} wqkv")
    _check_param(bqkv, (3 * d,), bf, dev, f"{name} bqkv")
    _check_param(wo, (d, d), bf, dev, f"{name} wo")
    _check_param(bo, (d,), bf, dev, f"{name} bo")
    return b, sp, d


def _attn_launch(name, entry, x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads,
                 n_valid, causal):
    """The attention block's launch chain through ``entry`` (wt_attn_block
    or wt_attn_block_res: one chain, the two differ in who owns qkv):
    (out, qkv (B, SP, 3D) bf16)."""
    b, sp, d = _check_attn(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads,
                           n_valid, name)
    lib = load_library()
    m = b * sp
    scratch = dict(dtype=torch.bfloat16, device=x.device)
    y = torch.empty((m, d), **scratch)
    qkv = torch.empty((b, sp, 3 * d), **scratch)
    att = torch.empty((m, d), **scratch)
    out = torch.empty_like(x)
    check(getattr(lib, entry)(
        *_ptrs(x), _is_f32(x), *_ptrs(ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                     out, y, qkv, att),
        b, sp, d, heads, int(n_valid), int(causal), _stream(x)), name)
    _launches.add(name, sp, d)
    return out, qkv


def fused_attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads: int,
                     n_valid: int, causal: bool = False):
    """x (B, SP, D) -> x + out_proj(MHA(LN(x))); key columns >= n_valid are
    masked, ``causal`` also masks columns above the query row."""
    if not x.is_cuda:
        return plain_attn_block(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                heads, n_valid, causal)
    name = "fused_attn_block"
    _refuse_grad(name, "fused_attn_block_train", x, ln_scale, ln_bias, wqkv,
                 bqkv, wo, bo)
    return _attn_launch(name, "wt_attn_block", x, ln_scale, ln_bias, wqkv,
                        bqkv, wo, bo, heads, n_valid, causal)[0]


def fused_attn_block_res(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads: int,
                         n_valid: int, causal: bool = False):
    """The training forward of the attention block: (fused_attn_block's
    output, the post-bias qkv (B, SP, 3D) in the weight dtype, bf16 even
    under an f32 stream). On this card the serve kernel and the training
    kernel are one launch chain: the qkv GEMM writes qkv to device memory
    between its launch and the attention's either way, once, through its
    bias epilogue. They differ in who owns that buffer: the serve wrapper
    drops it as scratch, this one hands it to the backward."""
    if not x.is_cuda:
        return plain_attn_block_res(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                    heads, n_valid, causal)
    name = "fused_attn_block_res"
    _refuse_grad(name, "fused_attn_block_train", x, ln_scale, ln_bias, wqkv,
                 bqkv, wo, bo)
    return _attn_launch(name, "wt_attn_block_res", x, ln_scale, ln_bias, wqkv,
                        bqkv, wo, bo, heads, n_valid, causal)


def _check_mlp(x, ln_scale, ln_bias, wfc, bfc, act, name):
    _require(act in ACTS, f"{name}: unknown activation {act!r}")
    b, sp, d = _check_x(x, name)
    f = wfc.shape[-1]
    _require(f % 128 == 0, f"{name}: hidden width {f} not a multiple of 128")
    dev, bf = x.device, torch.bfloat16
    _check_param(ln_scale, (d,), torch.float32, dev, f"{name} ln_scale")
    _check_param(ln_bias, (d,), torch.float32, dev, f"{name} ln_bias")
    _check_param(wfc, (d, f), bf, dev, f"{name} wfc")
    _check_param(bfc, (f,), bf, dev, f"{name} bfc")
    return b, sp, d, f


def _check_proj(wproj, bproj, d, f, dev, name):
    _check_param(wproj, (f, d), torch.bfloat16, dev, f"{name} wproj")
    _check_param(bproj, (d,), torch.bfloat16, dev, f"{name} bproj")


def _mlp_block_launch(name, x, ln_scale, ln_bias, wfc, bfc, wproj, bproj, act,
                      res: bool):
    """(out, h_pre or None): wt_mlp_block, or with ``res`` wt_mlp_block_res."""
    b, sp, d, f = _check_mlp(x, ln_scale, ln_bias, wfc, bfc, act, name)
    _check_proj(wproj, bproj, d, f, x.device, name)
    lib = load_library()
    m = b * sp
    bf = dict(dtype=torch.bfloat16, device=x.device)
    y = torch.empty((m, d), **bf)
    h = torch.empty((m, f), **bf)
    out = torch.empty_like(x)
    h_pre = torch.empty((b, sp, f), **bf) if res else None
    head = (*_ptrs(x), _is_f32(x), *_ptrs(ln_scale, ln_bias, wfc, bfc, wproj,
                                          bproj, out))
    tail = (m, d, f, ACTS[act], _stream(x))
    if res:
        check(lib.wt_mlp_block_res(*head, *_ptrs(h_pre, y, h), *tail), name)
    else:
        check(lib.wt_mlp_block(*head, *_ptrs(y, h), *tail), name)
    _launches.add(name, sp, d)
    return out, h_pre


def fused_mlp_block(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj,
                    act: str = "gelu"):
    """x (B, SP, D) -> x + proj(act(fc(LN(x))))."""
    if not x.is_cuda:
        return plain_mlp_block(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj,
                               act)
    name = "fused_mlp_block"
    _refuse_grad(name, "fused_mlp_block_train", x, ln_scale, ln_bias, wfc,
                 bfc, wproj, bproj)
    return _mlp_block_launch(name, x, ln_scale, ln_bias, wfc, bfc, wproj,
                             bproj, act, res=False)[0]


def fused_mlp_block_res(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj,
                        act: str = "gelu"):
    """The training forward of the MLP block: (fused_mlp_block's output, the
    pre-activation fc output (B, SP, F) in the weight dtype). The fc GEMM's
    epilogue stores both values from one f32 accumulator: the activated h
    from the unrounded sum, as in serving, and the sum rounded to bf16 as
    the residual. The rounded value is the one the backward differentiates
    the activation at, as the reference's and both plain versions do; h
    differs from the activation of the rounded value by under one bf16 ulp."""
    if not x.is_cuda:
        return plain_mlp_block_res(x, ln_scale, ln_bias, wfc, bfc, wproj,
                                   bproj, act)
    name = "fused_mlp_block_res"
    _refuse_grad(name, "fused_mlp_block_train", x, ln_scale, ln_bias, wfc,
                 bfc, wproj, bproj)
    return _mlp_block_launch(name, x, ln_scale, ln_bias, wfc, bfc, wproj,
                             bproj, act, res=True)


def _mlp_fc_launch(name, x, ln_scale, ln_bias, wfc, bfc, act, res: bool):
    """(h, h_pre or None): wt_mlp_fc, or with ``res`` wt_mlp_fc_res."""
    b, sp, d, f = _check_mlp(x, ln_scale, ln_bias, wfc, bfc, act, name)
    lib = load_library()
    bf = dict(dtype=torch.bfloat16, device=x.device)
    y = torch.empty((b * sp, d), **bf)
    h = torch.empty((b, sp, f), **bf)
    h_pre = torch.empty((b, sp, f), **bf) if res else None
    head = (*_ptrs(x), _is_f32(x), *_ptrs(ln_scale, ln_bias, wfc, bfc, h))
    tail = (b * sp, d, f, ACTS[act], _stream(x))
    if res:
        check(lib.wt_mlp_fc_res(*head, *_ptrs(h_pre, y), *tail), name)
    else:
        check(lib.wt_mlp_fc(*head, *_ptrs(y), *tail), name)
    _launches.add(name, sp, d)
    return h, h_pre


def fused_mlp_fc(x, ln_scale, ln_bias, wfc, bfc, act: str = "gelu"):
    """The first half of the split MLP: x (B, SP, D) -> h = act(fc(LN(x)))
    as (B, SP, F) bf16 in device memory; h rounds once, after the
    activation."""
    if not x.is_cuda:
        return plain_mlp_fc(x, ln_scale, ln_bias, wfc, bfc, act)
    name = "fused_mlp_fc"
    _refuse_grad(name, "fused_mlp_split_train", x, ln_scale, ln_bias, wfc, bfc)
    return _mlp_fc_launch(name, x, ln_scale, ln_bias, wfc, bfc, act,
                          res=False)[0]


def fused_mlp_fc_res(x, ln_scale, ln_bias, wfc, bfc, act: str = "gelu"):
    """The first half of the split MLP's training forward: (h, h_pre), both
    (B, SP, F) bf16 in device memory; see fused_mlp_block_res for the two
    roundings."""
    if not x.is_cuda:
        return plain_mlp_fc_res(x, ln_scale, ln_bias, wfc, bfc, act)
    name = "fused_mlp_fc_res"
    _refuse_grad(name, "fused_mlp_split_train", x, ln_scale, ln_bias, wfc, bfc)
    return _mlp_fc_launch(name, x, ln_scale, ln_bias, wfc, bfc, act, res=True)


def _proj_launch(name, entry, h, w, b, x):
    """x + (h @ w + b) in x's dtype through ``entry`` (wt_mlp_proj or
    wt_residual_matmul: one GEMM with the residual epilogue)."""
    bsz, sp, d = _check_x(x, name)
    f = w.shape[0]
    _require(f % 32 == 0, f"{name}: inner width {f} not a multiple of 32")
    _check_param(h, (bsz, sp, f), torch.bfloat16, x.device, f"{name} h")
    _check_proj(w, b, d, f, x.device, name)
    lib = load_library()
    out = torch.empty_like(x)
    check(getattr(lib, entry)(
        *_ptrs(h, w, b, x), _is_f32(x), *_ptrs(out), bsz * sp, d, f,
        _stream(x)), name)
    _launches.add(name, sp, d)
    return out


def fused_mlp_proj(h, wproj, bproj, x):
    """The second half: h (B, SP, F) bf16, x (B, SP, D) ->
    x + (proj(h) + b) in x's dtype."""
    if not x.is_cuda:
        return plain_mlp_proj(h, wproj, bproj, x)
    name = "fused_mlp_proj"
    _refuse_grad(name, "fused_mlp_split_train", h, wproj, bproj, x)
    return _proj_launch(name, "wt_mlp_proj", h, wproj, bproj, x)


def fused_mlp_split(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj,
                    act: str = "gelu"):
    """x (B, SP, D) -> x + proj(act(fc(LN(x)))) as the two-kernel pair:
    fused_mlp_fc writes h, fused_mlp_proj reads it back. The pair launches
    nothing of its own, so it has no count: each half counts itself."""
    if not x.is_cuda:
        return plain_mlp_split(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj,
                               act)
    h = fused_mlp_fc(x, ln_scale, ln_bias, wfc, bfc, act)
    return fused_mlp_proj(h, wproj, bproj, x)


def fused_mlp_split_res(x, ln_scale, ln_bias, wfc, bfc, wproj, bproj,
                        act: str = "gelu"):
    """The training forward of the split pair: (fused_mlp_split's output,
    the pre-activation fc output (B, SP, F)). fused_mlp_fc_res writes h and
    h_pre, fused_mlp_proj closes the block unchanged; each half counts
    itself."""
    if not x.is_cuda:
        return plain_mlp_split_res(x, ln_scale, ln_bias, wfc, bfc, wproj,
                                   bproj, act)
    h, h_pre = fused_mlp_fc_res(x, ln_scale, ln_bias, wfc, bfc, act)
    return fused_mlp_proj(h, wproj, bproj, x), h_pre


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
    _launches.add(name, sp, d)
    return out


def pooled_attention(q, kv, heads: int, n_valid: int, rows=None,
                     pool_row: int = 0, causal: bool = False,
                     group: int = 0):
    """The pooled blocks' attention alone (csrc/block_kernels.cu
    ``attention_pooled_kernel``, behind both pooled wrappers): q (B, D) bf16,
    kv (B, SP, 2D) bf16 rows [k | v], rows (B,) int32 or ``pool_row``
    -> (B, D) bf16, as plain_pooled_attention. ``group``: heads a block of
    the kernel takes (a power of two dividing heads, at most 16), 0 for the
    kernel's own choice."""
    if not q.is_cuda:
        return plain_pooled_attention(q, kv, heads, n_valid, rows, pool_row,
                                      causal)
    name = "pooled_attention"
    _refuse_grad(name, "fused_attn_block_pooled_train", q, kv)
    _require(kv.dim() == 3 and q.dim() == 2,
             f"{name}: q (B, D), kv (B, SP, 2D)")
    b, sp, d2 = kv.shape
    d = d2 // 2
    _check_param(q, (b, d), torch.bfloat16, kv.device, f"{name} q")
    _check_param(kv, (b, sp, 2 * d), torch.bfloat16, kv.device, f"{name} kv")
    _require(heads >= 1 and d % heads == 0 and d // heads in HEAD_DIMS
             and 1 <= sp <= MAX_SEQ and 1 <= n_valid <= sp,
             f"{name}: width {d}, heads {heads}, sequence {sp}, n_valid "
             f"{n_valid} not taken")
    if rows is not None:
        _check_param(rows, (b,), torch.int32, kv.device, f"{name} rows")
    else:
        _require(0 <= pool_row < sp,
                 f"{name}: pool_row {pool_row} out of range")
    att = torch.empty((b, d), dtype=torch.bfloat16, device=q.device)
    check(load_library().wt_attention_pooled(
        q.data_ptr(), kv.data_ptr(), d,
        None if rows is None else rows.data_ptr(), int(pool_row),
        att.data_ptr(), b, sp, heads, int(n_valid), int(causal), int(group),
        _stream(q)), name)
    _launches.add(name, sp, d)
    return att


def fused_attn_block_pooled(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                            heads: int, n_valid: int, pool_row: int = 0,
                            causal: bool = False):
    """x (B, SP, D) -> (x + out_proj(MHA(LN(x))))[:, pool_row] as (B, D)."""
    if not x.is_cuda:
        return plain_attn_block_pooled(x, ln_scale, ln_bias, wqkv, bqkv, wo,
                                       bo, heads, n_valid, pool_row, causal)
    _refuse_grad("fused_attn_block_pooled", "fused_attn_block_pooled_train",
                 x, ln_scale, ln_bias, wqkv, bqkv, wo, bo)
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
    _refuse_grad(name, "fused_attn_block_pooled_dyn_train", x, ln_scale,
                 ln_bias, wqkv, bqkv, wo, bo)
    _check_param(rows, (x.shape[0],), torch.int32, x.device, f"{name} rows")
    return _pooled_launch(name, x, rows, 0, ln_scale, ln_bias, wqkv, bqkv, wo,
                          bo, heads, n_valid, causal)


# ---------------------------------------------------------------------------
# the padded-head attention block (wise_tpu/ops/block.py:1255-1450). Each
# head's q/k/v slot is zero-padded to HEAD_PAD lanes in the weights (zero K
# columns add nothing to a logit, zero V columns give zero output columns,
# and wo gets zero rows there): three fused_ln_matmul for q, k and v, the
# attention middle at width heads x HEAD_PAD with the softmax scale of the
# true head_dim, and fused_residual_matmul. The reference built it for a TPU
# layout reason (head slices at 80-lane offsets); it runs the LayerNorm
# three times and the attention-side GEMMs HEAD_PAD / hd times as wide
# (1.6x at head_dim 80). The port keeps that design and the gate.
# ---------------------------------------------------------------------------

#: lanes each head's q/k/v slot is zero-padded to
HEAD_PAD = 128
#: (SP, D) shapes on which a tower takes the padded-head block. Empty, as the
#: reference's ``_CALIBRATED_PAD`` is: a shape enters only when a measurement
#: on the card shows the block beating the path in use.
_CALIBRATED_PAD: set = set()


def supports_fused_block_padded(seq: int, width: int, heads: int) -> bool:
    """Whether a tower of this shape takes the padded-head block: a head_dim
    under HEAD_PAD that is not a multiple of 64, a sequence the attention
    kernel takes, and (seq, width) in the table. The reference's other
    terms (the bf16 dtype, seq % 8, VMEM groups, the TPU backend) belong to
    the TPU or to the caller (the model asks only for bf16 block towers)."""
    if (seq, width) not in _CALIBRATED_PAD or heads < 1 or width % heads:
        return False
    hd = width // heads
    return hd < HEAD_PAD and hd % 64 != 0 and 1 <= seq <= MAX_SEQ


def plain_ln_matmul(x, ln_s, ln_b, w, b, act: str = "none"):
    """act(LN(x) @ w + b) in x's dtype: LN(x) rounds to the weight dtype
    (the GEMM operand), the product, bias and activation are f32, and the
    result rounds once, to x's dtype."""
    y = layer_norm_f32(x, ln_s, ln_b).to(w.dtype).float()
    return activation(y @ w.float() + b.float(), act).to(x.dtype)


def plain_residual_matmul(x, h, w, b):
    """x + (h @ w + b) in x's dtype."""
    return plain_mlp_proj(h, w, b, x)


def fused_ln_matmul(x, ln_scale, ln_bias, w, b, act: str = "none"):
    """x (B, SP, D) -> act(LN(x) @ w + b) as (B, SP, OW) in x's dtype; w
    (D, OW) bf16, b (OW,) bf16."""
    if not x.is_cuda:
        return plain_ln_matmul(x, ln_scale, ln_bias, w, b, act)
    name = "fused_ln_matmul"
    _refuse_grad(name, "fused_attn_block_padded_train", x, ln_scale, ln_bias,
                 w, b)
    _require(act in ACTS, f"{name}: unknown activation {act!r}")
    bsz, sp, d = _check_x(x, name)
    ow = w.shape[-1]
    _require(ow % 8 == 0, f"{name}: output width {ow} not a multiple of 8")
    dev, bf = x.device, torch.bfloat16
    _check_param(ln_scale, (d,), torch.float32, dev, f"{name} ln_scale")
    _check_param(ln_bias, (d,), torch.float32, dev, f"{name} ln_bias")
    _check_param(w, (d, ow), bf, dev, f"{name} w")
    _check_param(b, (ow,), bf, dev, f"{name} b")
    lib = load_library()
    y = torch.empty((bsz * sp, d), dtype=bf, device=dev)
    out = torch.empty((bsz, sp, ow), dtype=x.dtype, device=dev)
    check(lib.wt_ln_matmul(
        *_ptrs(x), _is_f32(x), *_ptrs(ln_scale, ln_bias, w, b, out, y),
        bsz * sp, d, ow, ACTS[act], _stream(x)), name)
    _launches.add(name, sp, d)
    return out


def fused_residual_matmul(x, h, w, b):
    """x (B, SP, D), h (B, SP, IW) bf16 -> x + (h @ w + b) in x's dtype; w
    (IW, D) bf16, b (D,) bf16."""
    if not x.is_cuda:
        return plain_residual_matmul(x, h, w, b)
    name = "fused_residual_matmul"
    _refuse_grad(name, "fused_attn_block_padded_train", x, h, w, b)
    return _proj_launch(name, "wt_residual_matmul", h, w, b, x)


def _pad_head_weights(wqkv, bqkv, wo, heads: int, hd: int, hp: int):
    """Zero-pad each head's slot to hp lanes: ((wq, bq), (wk, bk), (wv, bv),
    wo_pad) with wq (D, heads * hp), bq (heads * hp,), wo_pad (heads * hp,
    D). Weight tensors only; the activation stream is never padded."""
    d = wqkv.shape[0]
    pad = torch.nn.functional.pad

    def slot(i):
        w = pad(wqkv[:, i * d:(i + 1) * d].reshape(d, heads, hd),
                (0, hp - hd))
        bb = pad(bqkv[i * d:(i + 1) * d].reshape(heads, hd), (0, hp - hd))
        return w.reshape(d, heads * hp), bb.reshape(heads * hp)

    wo_pad = pad(wo.reshape(heads, hd, d), (0, 0, 0, hp - hd))
    return slot(0), slot(1), slot(2), wo_pad.reshape(heads * hp, d)


def fused_attn_block_padded(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                            heads: int, n_valid: int, causal: bool = False):
    """fused_attn_block's contract for head dims under HEAD_PAD, as five
    wrapper calls: q, k and v each by fused_ln_matmul on padded weights,
    fused_short_attention at head_dim HEAD_PAD with the scale of the true
    head_dim, and fused_residual_matmul with the zero-row out-projection.

    One deviation from the reference: there fused_ln_matmul hands q, k and v
    over in x's dtype, f32 under the vision towers' f32 stream, while the
    attention kernel here takes bf16; q, k and v round to bf16 here, on
    both devices, so the plain chain and the kernel chain compute one
    function."""
    from .attention import fused_short_attention

    d = x.shape[-1]
    _require(heads >= 1 and d % heads == 0 and d // heads <= HEAD_PAD,
             f"fused_attn_block_padded: head_dim {d / max(heads, 1):g} "
             f"above {HEAD_PAD}")
    hd = d // heads
    *qkv, wo_pad = _pad_head_weights(wqkv, bqkv, wo, heads, hd, HEAD_PAD)
    q, k, v = (fused_ln_matmul(x, ln_scale, ln_bias, w, b).to(torch.bfloat16)
               for w, b in qkv)
    att = fused_short_attention(q, k, v, heads, n_valid, causal,
                                scale=1.0 / math.sqrt(hd))
    return fused_residual_matmul(x, att, wo_pad, bo)


# ---------------------------------------------------------------------------
# head-split forms (tensor parallelism over 'mp', parallel/distributed.py).
# The reference shards the block's weights over 'mp' and lets GSPMD insert
# the collectives (wise_tpu/parallel/train.py:31-46); here a rank holds H/mp
# whole heads: wqkv (D, 3E) = [q | k | v] of its heads, E = H hd / mp, bqkv
# (3E,), wo (E, D) its rows of the out-projection; of the MLP wfc (D, F/mp),
# bfc (F/mp,), wproj (F/mp, D). A rank's chain ends in an f32 partial of the
# out-projection (or fc2) with no bias and no residual; ``mp_close`` sums the
# partials over the ranks (one all_reduce, in f32) and adds the bias and the
# residual once, on every rank. The LayerNorm in front runs whole on every
# rank. The kernels are the block chain's own (layernorm_kernel, gemm_kernel,
# attention_kernel<HD> and attention_pooled_kernel<HD> at H/mp heads), behind
# new C entries that take the inner width E apart from D
# (csrc/block_kernels.cu wt_attn_block_partial, wt_attn_block_pooled_partial,
# wt_mlp_proj_partial; the fc half is wt_mlp_fc(_res) at F/mp).
#
# ``tp`` is the rank's parallel/distributed.py TensorParallel: its ``copy``
# sums LN(x)'s cotangent over the ranks in a plain form's backward, its
# ``reduce`` the partials forward. A plain form with ``tp`` None has no
# collective: the rank's partial alone, which a test sums by hand.
#
# Every part that is summed over the ranks is formed in f32 and rounded once,
# after the sum, as the whole layer's GEMM rounds its f32 accumulator once:
# the out-projection's (or fc2's) partial forward (``split_out``, the
# kernels' f32 partial), and LN(x)'s cotangent backward (``mp_in`` with
# ``col_matmul`` in the plain forms, ``_dense_bwd`` in the training rules).
# ---------------------------------------------------------------------------


def mp_close(x, partial, bias, tp):
    """x + (the ranks' partials summed + bias), in x's dtype: the sum in f32,
    rounded once into x's dtype (as the whole block's epilogue rounds its
    f32 accumulator), then added."""
    return x + (tp.reduce(partial) + bias.float()).to(x.dtype)


def mp_dense(partial, bias, tp, dtype):
    """A row-split plain Dense closed over the ranks: the partials summed
    in f32 and rounded once into ``dtype``, then the bias added in
    ``dtype``, the rounding points of the whole layer's ``x @ w + b``
    (models/clip/model.py ``Dense``; the kernels' epilogue is mp_close's)."""
    return tp.reduce(partial).to(dtype) + bias.to(dtype)


def mp_in(y, tp=None):
    """LN(x), already in its compute dtype, as the rank's column-split
    layers read it: its values in f32, so that their products (col_matmul)
    hand back an f32 cotangent. Under ``tp`` that cotangent, the ranks'
    parts summed in f32 (``tp.copy``), is rounded once into y's dtype where
    it leaves (the pullback of ``.float()``), as the whole layer's g @ w.T
    is rounded once."""
    y32 = y.float()
    return y32 if tp is None else tp.copy(y32)


def col_matmul(y32, w):
    """mp_in's y times the rank's columns of ``w``: the products of the
    compute dtype's values accumulated in f32 and rounded once into w's
    dtype, as the whole layer's GEMM."""
    return (y32 @ w.float()).to(w.dtype)


def split_out(a, w):
    """a @ w for a layer split by input row (the out-projection, fc2): the
    rank's f32 partial, products of a's and w's values accumulated in f32
    and not rounded; mp_close sums the partials and rounds once."""
    return a.float() @ w.float()


def _pool_index(x, rows, pool_row):
    """Each example's pooled row, clamped into [0, SP) (int64 (B,))."""
    b, sp = x.shape[:2]
    if rows is None:
        return torch.full((b,), pool_row, dtype=torch.long, device=x.device)
    return rows.long().clamp(0, sp - 1)


def pooled_rows(x, rows, pool_row: int = 0):
    """x at each example's pooled row, (B, D): the pooled block's residual."""
    return x[torch.arange(x.shape[0], device=x.device),
             _pool_index(x, rows, pool_row)]


def plain_attn_partial(x, ln_s, ln_b, wqkv, bqkv, wo, heads: int,
                       n_valid: int, causal: bool = False, tp=None):
    """The rank's part of the attention block: (MHA over its ``heads`` of
    LN(x) @ wo, (B, SP, D) f32 without bias; its post-bias qkv (B, SP, 3E)
    in the weight dtype)."""
    y = mp_in(layer_norm_f32(x, ln_s, ln_b).to(wqkv.dtype), tp)
    qkv = col_matmul(y, wqkv) + bqkv
    att = attention_of_qkv(qkv, heads, n_valid, causal)
    return split_out(att, wo), qkv


def plain_mlp_partial(x, ln_s, ln_b, wfc, bfc, wproj, act: str = "gelu",
                      tp=None):
    """The rank's part of the MLP block: (proj(act(fc(LN(x)))) over its F/mp
    columns, (B, SP, D) f32 without bias; its pre-activation fc output)."""
    y = mp_in(layer_norm_f32(x, ln_s, ln_b).to(wfc.dtype), tp)
    h_pre = col_matmul(y, wfc) + bfc
    h = activation(h_pre.float(), act).to(h_pre.dtype)
    return split_out(h, wproj), h_pre


def plain_attn_pooled_partial(x, rows, ln_s, ln_b, wqkv, bqkv, wo, heads: int,
                              n_valid: int, pool_row: int = 0,
                              causal: bool = False, tp=None):
    """The rank's part of the pooled attention block at each example's row
    (``rows`` (B,), else ``pool_row``): (B, D) f32 without bias."""
    e = wqkv.shape[1] // 3
    y = mp_in(layer_norm_f32(x, ln_s, ln_b).to(wqkv.dtype), tp)
    kv = col_matmul(y, wqkv[:, e:]) + bqkv[e:]
    idx = _pool_index(x, rows, pool_row)
    q = col_matmul(y[torch.arange(x.shape[0], device=x.device), idx],
                   wqkv[:, :e]) + bqkv[:e]
    att = plain_pooled_attention(q, kv, heads, n_valid, idx, causal=causal)
    return split_out(att, wo)


def _check_split_attn(x, ln_s, ln_b, wqkv, bqkv, wo, heads, n_valid, name):
    b, sp, d = _check_x(x, name)
    e = wqkv.shape[-1] // 3
    _require(heads >= 1 and e % heads == 0 and e // heads in HEAD_DIMS
             and e % 32 == 0,
             f"{name}: {heads} heads over width {e}: head_dim not in "
             f"{HEAD_DIMS}")
    _require(1 <= n_valid <= sp, f"{name}: n_valid {n_valid} not in [1, {sp}]")
    dev, bf = x.device, torch.bfloat16
    _check_param(ln_s, (d,), torch.float32, dev, f"{name} ln_scale")
    _check_param(ln_b, (d,), torch.float32, dev, f"{name} ln_bias")
    _check_param(wqkv, (d, 3 * e), bf, dev, f"{name} wqkv")
    _check_param(bqkv, (3 * e,), bf, dev, f"{name} bqkv")
    _check_param(wo, (e, d), bf, dev, f"{name} wo")
    return b, sp, d, e


def fused_attn_partial(x, ln_s, ln_b, wqkv, bqkv, wo, heads: int,
                       n_valid: int, causal: bool = False):
    """The head-split attention chain (wt_attn_block_partial): LayerNorm,
    the qkv GEMM D -> 3E, the attention over the rank's ``heads`` with
    stride E, the out-proj GEMM E -> D into an f32 partial; as
    plain_attn_partial, (partial, qkv)."""
    if not x.is_cuda:
        return plain_attn_partial(x, ln_s, ln_b, wqkv, bqkv, wo, heads,
                                  n_valid, causal)
    name = "fused_attn_block_mp"
    _refuse_grad(name, "fused_attn_block_mp_train", x, ln_s, ln_b, wqkv,
                 bqkv, wo)
    b, sp, d, e = _check_split_attn(x, ln_s, ln_b, wqkv, bqkv, wo, heads,
                                    n_valid, name)
    m = b * sp
    bf = dict(dtype=torch.bfloat16, device=x.device)
    y = torch.empty((m, d), **bf)
    qkv = torch.empty((b, sp, 3 * e), **bf)
    att = torch.empty((m, e), **bf)
    partial = torch.empty((b, sp, d), dtype=torch.float32, device=x.device)
    check(load_library().wt_attn_block_partial(
        *_ptrs(x), _is_f32(x), *_ptrs(ln_s, ln_b, wqkv, bqkv, wo, partial, y,
                                     qkv, att),
        b, sp, d, e, heads, int(n_valid), int(causal), _stream(x)), name)
    _launches.add(name, sp, d)
    return partial, qkv


def fused_mlp_fc_mp(x, ln_s, ln_b, wfc, bfc, act: str = "gelu",
                    res: bool = True):
    """The head-split MLP's first half: fused_mlp_fc(_res)'s chain
    (wt_mlp_fc(_res)) at the rank's F/mp columns: (h, h_pre), h_pre None
    without ``res``."""
    if not x.is_cuda:
        return plain_mlp_fc_res(x, ln_s, ln_b, wfc, bfc, act)
    name = "fused_mlp_fc_mp"
    _refuse_grad(name, "fused_mlp_mp_train", x, ln_s, ln_b, wfc, bfc)
    return _mlp_fc_launch(name, x, ln_s, ln_b, wfc, bfc, act, res)


def fused_mlp_proj_partial(h, wproj, x):
    """The head-split MLP's second half (wt_mlp_proj_partial): h (B, SP,
    F/mp) bf16 times the rank's rows of wproj, an f32 partial (B, SP, D)
    with no bias or residual; ``x`` gives the shape and the device."""
    if not h.is_cuda:
        return split_out(h, wproj)
    name = "fused_mlp_proj_mp"
    _refuse_grad(name, "fused_mlp_mp_train", h, wproj)
    b, sp, d = _check_x(x, name)
    f = wproj.shape[0]
    _check_param(h, (b, sp, f), torch.bfloat16, x.device, f"{name} h")
    _check_param(wproj, (f, d), torch.bfloat16, x.device, f"{name} wproj")
    partial = torch.empty((b, sp, d), dtype=torch.float32, device=x.device)
    check(load_library().wt_mlp_proj_partial(
        *_ptrs(h, wproj, partial), b * sp, d, f, _stream(x)), name)
    _launches.add(name, sp, d)
    return partial


def fused_mlp_partial(x, ln_s, ln_b, wfc, bfc, wproj, act: str = "gelu",
                      res: bool = True):
    """The head-split MLP pair, fused_mlp_fc_mp then fused_mlp_proj_partial;
    as plain_mlp_partial, (partial, h_pre), h_pre None without ``res``."""
    if not x.is_cuda:
        return plain_mlp_partial(x, ln_s, ln_b, wfc, bfc, wproj, act)
    h, h_pre = fused_mlp_fc_mp(x, ln_s, ln_b, wfc, bfc, act, res)
    return fused_mlp_proj_partial(h, wproj, x), h_pre


def fused_attn_pooled_partial(x, rows, ln_s, ln_b, wqkv, bqkv, wo,
                              heads: int, n_valid: int, pool_row: int = 0,
                              causal: bool = False):
    """The head-split pooled chain (wt_attn_block_pooled_partial): k/v of
    the rank's heads for every row, q, the pooled attention and the
    out-proj partial at each example's row; as plain_attn_pooled_partial."""
    if not x.is_cuda:
        return plain_attn_pooled_partial(x, rows, ln_s, ln_b, wqkv, bqkv, wo,
                                         heads, n_valid, pool_row, causal)
    name = ("fused_attn_block_pooled_mp" if rows is None
            else "fused_attn_block_pooled_dyn_mp")
    _refuse_grad(name, name + "_train", x, ln_s, ln_b, wqkv, bqkv, wo)
    b, sp, d, e = _check_split_attn(x, ln_s, ln_b, wqkv, bqkv, wo, heads,
                                    n_valid, name)
    if rows is not None:
        _check_param(rows, (b,), torch.int32, x.device, f"{name} rows")
    else:
        _require(0 <= pool_row < sp, f"{name}: pool_row {pool_row} out of "
                 "range")
    bf = dict(dtype=torch.bfloat16, device=x.device)
    y = torch.empty((b * sp, d), **bf)
    yrows = torch.empty((b, d), **bf)
    kv = torch.empty((b * sp, 2 * e), **bf)
    q = torch.empty((b, e), **bf)
    att = torch.empty((b, e), **bf)
    partial = torch.empty((b, d), dtype=torch.float32, device=x.device)
    check(load_library().wt_attn_block_pooled_partial(
        *_ptrs(x), _is_f32(x), *_ptrs(ln_s, ln_b, wqkv, bqkv, wo),
        None if rows is None else rows.data_ptr(), int(pool_row),
        *_ptrs(partial, y, yrows, kv, q, att), b, sp, d, e, heads,
        int(n_valid), int(causal), _stream(x)), name)
    _launches.add(name, sp, d)
    return partial


def plain_attn_block_mp(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads: int,
                        n_valid: int, causal: bool = False, tp=None):
    """The attention block on the rank's heads, closed over the ranks:
    plain PyTorch, differentiable (``tp.copy`` and ``tp.reduce``)."""
    partial, _ = plain_attn_partial(x, ln_s, ln_b, wqkv, bqkv, wo, heads,
                                    n_valid, causal, tp)
    return mp_close(x, partial, bo, tp)


def plain_mlp_block_mp(x, ln_s, ln_b, wfc, bfc, wproj, bproj,
                       act: str = "gelu", tp=None):
    """The MLP block on the rank's F/mp columns, closed over the ranks."""
    partial, _ = plain_mlp_partial(x, ln_s, ln_b, wfc, bfc, wproj, act, tp)
    return mp_close(x, partial, bproj, tp)


def plain_attn_block_pooled_mp(x, rows, ln_s, ln_b, wqkv, bqkv, wo, bo,
                               heads: int, n_valid: int, pool_row: int = 0,
                               causal: bool = False, tp=None):
    """The pooled attention block on the rank's heads, closed over the
    ranks at each example's row: (B, D)."""
    partial = plain_attn_pooled_partial(x, rows, ln_s, ln_b, wqkv, bqkv, wo,
                                        heads, n_valid, pool_row, causal, tp)
    return mp_close(pooled_rows(x, rows, pool_row), partial, bo, tp)


# ---------------------------------------------------------------------------
# autograd rules (wise_tpu/ops/block.py:1849-2045). The reference's backward
# rules are jax.vjp over plain stage functions, not kernels; so are these:
# plain PyTorch from the saved residual, or a recompute of the plain block.
#
# The reference also carries a ``None``-residual arm (_attn_saved_bwd,
# _mlp_saved_bwd, _attn_train_fwd), taken when the extra output does not
# fit VMEM. Device memory holds the residual at every shape the kernels
# take, so that arm has no counterpart here.
# ---------------------------------------------------------------------------


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _leaves(*tensors):
    return [t.detach().requires_grad_() for t in tensors]


def _dense_bwd(a, w, g, tp=None):
    """Pull ``g``, the cotangent of ``a @ w + b``, back to (a, w, b): what
    autograd derives for the expression, written out so that the product
    itself is not computed again. Under a head split (``tp``) ``w`` holds
    the rank's columns of a layer that reads the replicated ``a``: a's
    cotangent is the rank's part formed in f32, summed over the 'mp' ranks
    and rounded once into a's dtype, as the whole layer's g @ w.T is."""
    a2, g2 = a.flatten(0, -2), g.flatten(0, -2)
    g_a = (g @ w.T if tp is None
           else tp.reduce_cotangent(g.float() @ w.float().T).to(a.dtype))
    return g_a, a2.T @ g2, g2.sum(0)


def _stage_a_bwd(x, ln_s, ln_b, w, g, tp=None):
    """Pull ``g``, the cotangent of LN(x).to(w.dtype) @ w + b, back to (x,
    ln_s, ln_b, w, b). The GEMM's own output is not needed for that, so it
    is not computed again: its three pullbacks are written out (what
    autograd derives for ``y @ w + b``), and autograd differentiates only
    the LayerNorm. Under a head split (``tp``) ``w`` holds the rank's
    columns, and LN(x)'s cotangent is summed over the 'mp' ranks before the
    LayerNorm's pullback: after it x, ln_s and ln_b have their whole
    gradient on every rank."""
    x, ln_s, ln_b = _leaves(x, ln_s, ln_b)
    with torch.enable_grad():
        y = layer_norm_f32(x, ln_s, ln_b).to(w.dtype)
    g_y, g_w, g_b = _dense_bwd(y.detach(), w, g.to(w.dtype), tp)
    gx, g_ls, g_lb = torch.autograd.grad(y, (x, ln_s, ln_b), g_y)
    return gx, g_ls, g_lb, g_w, g_b


class _AttnBlockTrain(torch.autograd.Function):
    """fused_attn_block_train and, with an 'mp' group ``tp``, its head-split
    form (fused_attn_block_mp_train): the forward is the head-split chain
    and the close over the ranks, the backward the same rule on the rank's
    slices (wqkv (D, 3E), wo (E, D), ``heads`` of the rank), whose one
    collective sums LN(x)'s cotangent (_stage_a_bwd)."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, n_valid,
                causal, tp=None):
        if tp is None:
            out, qkv = fused_attn_block_res(x, ln_s, ln_b, wqkv, bqkv, wo,
                                            bo, heads, n_valid, causal)
        else:
            partial, qkv = fused_attn_partial(x, ln_s, ln_b, wqkv, bqkv, wo,
                                              heads, n_valid, causal)
            out = mp_close(x, partial, bo, tp)
        ctx.save_for_backward(x, qkv, ln_s, ln_b, wqkv, wo)
        ctx.static, ctx.tp = (heads, n_valid, causal), tp
        return out

    @staticmethod
    def backward(ctx, g):
        """From the saved qkv: the second stage (attn_from_qkv: attention,
        out-proj, residual) is differentiated at qkv, the first (qkv_stage)
        from its cotangent. Of the second stage only the attention is run
        again, under autograd; the out-proj's pullbacks are written out and
        its product, which no gradient needs, is left out (XLA drops it
        from the reference's jax.vjp as dead code). The kernel leaves output
        rows >= n_valid undefined where the plain stage computes values, so
        the cotangent is zeroed there."""
        x, qkv, ln_s, ln_b, wqkv, wo = ctx.saved_tensors
        heads, n_valid, causal = ctx.static
        if n_valid < g.shape[1]:
            g = g.clone()
            g[:, n_valid:] = 0
        qkv_, = _leaves(qkv)
        with torch.enable_grad():
            att = attention_of_qkv(qkv_, heads, n_valid, causal)
        g_att, g_wo, g_bo = _dense_bwd(att.detach(), wo, g.to(wo.dtype))
        g_qkv, = torch.autograd.grad(att, qkv_, g_att)
        gx2, g_ls, g_lb, g_wqkv, g_bqkv = _stage_a_bwd(x, ln_s, ln_b, wqkv,
                                                       g_qkv, ctx.tp)
        return (g + gx2, g_ls, g_lb, g_wqkv, g_bqkv, g_wo, g_bo, None, None,
                None, None)


class _MlpBlockTrain(torch.autograd.Function):
    """fused_mlp_block_train and fused_mlp_split_train: ``split`` picks the
    forward, the backward is one rule (the split is a detail of the
    forward, not another function). With an 'mp' group ``tp``
    (fused_mlp_mp_train) the forward is the fc / proj pair at the rank's
    F/mp columns and the close over the ranks."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wfc, bfc, wproj, bproj, act, split,
                tp=None):
        if tp is None:
            res = fused_mlp_split_res if split else fused_mlp_block_res
            out, h_pre = res(x, ln_s, ln_b, wfc, bfc, wproj, bproj, act)
        else:
            partial, h_pre = fused_mlp_partial(x, ln_s, ln_b, wfc, bfc,
                                               wproj, act)
            out = mp_close(x, partial, bproj, tp)
        ctx.save_for_backward(x, h_pre, ln_s, ln_b, wfc, wproj)
        ctx.act, ctx.tp = act, tp
        return out

    @staticmethod
    def backward(ctx, g):
        """From the saved pre-activation output: mlp_from_h is
        differentiated at h_pre (the activation under autograd, the proj's
        pullbacks written out), fc_stage from its cotangent."""
        x, h_pre, ln_s, ln_b, wfc, wproj = ctx.saved_tensors
        h_, = _leaves(h_pre)
        with torch.enable_grad():
            h = activation(h_.float(), ctx.act).to(h_.dtype)
        g_act, g_wproj, g_bproj = _dense_bwd(h.detach(), wproj,
                                             g.to(wproj.dtype))
        g_h, = torch.autograd.grad(h, h_, g_act)
        gx2, g_ls, g_lb, g_wfc, g_bfc = _stage_a_bwd(x, ln_s, ln_b, wfc, g_h,
                                                     ctx.tp)
        return (g + gx2, g_ls, g_lb, g_wfc, g_bfc, g_wproj, g_bproj, None,
                None, None)


class _PooledTrain(torch.autograd.Function):
    """fused_attn_block_pooled_train (``rows`` None, the static ``pool_row``)
    and fused_attn_block_pooled_dyn_train: the serve kernel forward, and a
    backward that differentiates the plain pooled block at the saved
    inputs. ``rows`` gets no gradient. With an 'mp' group ``tp``
    (fused_attn_block_pooled_mp_train and _dyn_mp_train) the forward is the
    head-split pooled chain and the close over the ranks; the backward
    differentiates the rank's plain partial, whose LN(x) cotangent is summed
    over the ranks (``tp.copy``), and adds the close's pullbacks."""

    @staticmethod
    def forward(ctx, x, rows, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, n_valid,
                pool_row, causal, tp=None):
        params = (ln_s, ln_b, wqkv, bqkv, wo, bo)
        if tp is not None:
            partial = fused_attn_pooled_partial(x, rows, *params[:5], heads,
                                                n_valid, pool_row, causal)
            out = mp_close(pooled_rows(x, rows, pool_row), partial, bo, tp)
        elif rows is None:
            out = fused_attn_block_pooled(x, *params, heads, n_valid,
                                          pool_row, causal)
        else:
            out = fused_attn_block_pooled_dyn(x, rows, *params, heads,
                                              n_valid, causal)
        ctx.save_for_backward(x, *params)
        ctx.rows, ctx.static = rows, (heads, n_valid, pool_row, causal)
        ctx.tp = tp
        return out

    @staticmethod
    def backward(ctx, g):
        heads, n_valid, pool_row, causal = ctx.static
        x, *params = _leaves(*ctx.saved_tensors)
        if ctx.tp is not None:
            with torch.enable_grad():
                partial = plain_attn_pooled_partial(
                    x, ctx.rows, *params[:5], heads, n_valid, pool_row,
                    causal, ctx.tp)
            gx, *gp = torch.autograd.grad(partial, (x, *params[:5]),
                                          g.float())
            idx = _pool_index(x, ctx.rows, pool_row)
            gx = gx.index_put((torch.arange(x.shape[0], device=x.device),
                               idx), g.to(gx.dtype), accumulate=True)
            g_bo = g.sum(0).to(params[5].dtype)
            return (gx, None, *gp, g_bo, None, None, None, None, None)
        with torch.enable_grad():
            if ctx.rows is None:
                out = plain_attn_block_pooled(x, *params, heads, n_valid,
                                              pool_row, causal)
            else:
                out = plain_attn_block_pooled_dyn(x, ctx.rows, *params, heads,
                                                  n_valid, causal)
        gx, *gp = torch.autograd.grad(out, (x, *params), g)
        return (gx, None, *gp, None, None, None, None, None)


class _PaddedTrain(torch.autograd.Function):
    """fused_attn_block_padded_train: the padded chain forward, and a
    backward that differentiates plain_attn_block at the saved inputs (the
    reference's ``_recompute_bwd`` over ``plain_attn_block``: the padding is
    a detail of the forward, the function is the attention block's). The
    cotangent is zeroed at rows >= n_valid, where the forward's rows are
    the kernel's to leave undefined."""

    @staticmethod
    def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, n_valid,
                causal):
        out = fused_attn_block_padded(x, ln_s, ln_b, wqkv, bqkv, wo, bo,
                                      heads, n_valid, causal)
        ctx.save_for_backward(x, ln_s, ln_b, wqkv, bqkv, wo, bo)
        ctx.static = (heads, n_valid, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        heads, n_valid, causal = ctx.static
        if n_valid < g.shape[1]:
            g = g.clone()
            g[:, n_valid:] = 0
        x, *params = _leaves(*ctx.saved_tensors)
        with torch.enable_grad():
            out = plain_attn_block(x, *params, heads, n_valid, causal)
        return (*torch.autograd.grad(out, (x, *params), g), None, None, None)


def fused_attn_block_train(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads: int,
                           n_valid: int, causal: bool = False):
    """fused_attn_block for the towers: with a gradient required the
    forward is fused_attn_block_res and the backward starts from its qkv;
    with none it is the serve wrapper, which writes no extra buffer."""
    args = (x, ln_s, ln_b, wqkv, bqkv, wo, bo)
    if not _needs_grad(*args):
        return fused_attn_block(*args, heads, n_valid, causal)
    return _AttnBlockTrain.apply(*args, heads, n_valid, causal)


def fused_mlp_block_train(x, ln_s, ln_b, wfc, bfc, wproj, bproj,
                          act: str = "gelu"):
    """fused_mlp_block for the towers; under a gradient fused_mlp_block_res
    and a backward from its pre-activation output."""
    args = (x, ln_s, ln_b, wfc, bfc, wproj, bproj)
    if not _needs_grad(*args):
        return fused_mlp_block(*args, act)
    return _MlpBlockTrain.apply(*args, act, False)


def fused_mlp_split_train(x, ln_s, ln_b, wfc, bfc, wproj, bproj,
                          act: str = "gelu"):
    """fused_mlp_split for the towers; under a gradient
    fused_mlp_split_res and fused_mlp_block_train's backward."""
    args = (x, ln_s, ln_b, wfc, bfc, wproj, bproj)
    if not _needs_grad(*args):
        return fused_mlp_split(*args, act)
    return _MlpBlockTrain.apply(*args, act, True)


def fused_attn_block_pooled_train(x, ln_s, ln_b, wqkv, bqkv, wo, bo,
                                  heads: int, n_valid: int, pool_row: int = 0,
                                  causal: bool = False):
    """fused_attn_block_pooled for the towers; under a gradient the same
    kernel forward and a recompute backward."""
    args = (x, ln_s, ln_b, wqkv, bqkv, wo, bo)
    if not _needs_grad(*args):
        return fused_attn_block_pooled(*args, heads, n_valid, pool_row,
                                       causal)
    return _PooledTrain.apply(x, None, *args[1:], heads, n_valid, pool_row,
                              causal)


def fused_attn_block_pooled_dyn_train(x, rows, ln_s, ln_b, wqkv, bqkv, wo, bo,
                                      heads: int, n_valid: int,
                                      causal: bool = False):
    """fused_attn_block_pooled_dyn for the towers; under a gradient the
    same kernel forward and a recompute backward."""
    args = (x, ln_s, ln_b, wqkv, bqkv, wo, bo)
    if not _needs_grad(*args):
        return fused_attn_block_pooled_dyn(x, rows, *args[1:], heads, n_valid,
                                           causal)
    return _PooledTrain.apply(x, rows, *args[1:], heads, n_valid, 0, causal)


def fused_attn_block_padded_train(x, ln_s, ln_b, wqkv, bqkv, wo, bo,
                                  heads: int, n_valid: int,
                                  causal: bool = False):
    """fused_attn_block_padded for the towers; under a gradient the same
    five-call forward and a recompute backward through plain_attn_block."""
    args = (x, ln_s, ln_b, wqkv, bqkv, wo, bo)
    if not _needs_grad(*args):
        return fused_attn_block_padded(*args, heads, n_valid, causal)
    return _PaddedTrain.apply(*args, heads, n_valid, causal)


def fused_attn_block_mp_train(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads: int,
                              n_valid: int, causal: bool = False, tp=None):
    """The head-split attention block for the towers: fused_attn_partial
    and mp_close; under a gradient _AttnBlockTrain with ``tp``."""
    args = (x, ln_s, ln_b, wqkv, bqkv, wo, bo)
    if not _needs_grad(*args):
        partial, _ = fused_attn_partial(*args[:6], heads, n_valid, causal)
        return mp_close(x, partial, bo, tp)
    return _AttnBlockTrain.apply(*args, heads, n_valid, causal, tp)


def fused_mlp_mp_train(x, ln_s, ln_b, wfc, bfc, wproj, bproj,
                       act: str = "gelu", tp=None):
    """The head-split MLP block for the towers (every width: the fc / proj
    pair at F/mp); under a gradient _MlpBlockTrain with ``tp``."""
    args = (x, ln_s, ln_b, wfc, bfc, wproj, bproj)
    if not _needs_grad(*args):
        partial, _ = fused_mlp_partial(*args[:6], act, res=False)
        return mp_close(x, partial, bproj, tp)
    return _MlpBlockTrain.apply(*args, act, True, tp)


def fused_attn_block_pooled_mp_train(x, rows, ln_s, ln_b, wqkv, bqkv, wo, bo,
                                     heads: int, n_valid: int,
                                     pool_row: int = 0, causal: bool = False,
                                     tp=None):
    """The head-split pooled block for the towers (``rows`` per example, or
    the static ``pool_row``); under a gradient _PooledTrain with ``tp``."""
    args = (x, ln_s, ln_b, wqkv, bqkv, wo, bo)
    if not _needs_grad(*args):
        partial = fused_attn_pooled_partial(x, rows, *args[1:6], heads,
                                            n_valid, pool_row, causal)
        return mp_close(pooled_rows(x, rows, pool_row), partial, bo, tp)
    return _PooledTrain.apply(x, rows, *args[1:], heads, n_valid, pool_row,
                              causal, tp)
