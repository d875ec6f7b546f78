"""The port's block ops at the ViT-H/14 traits (wise_tpu_torch/ops/block.py)
against the JAX package's: head_dim 80, a sequence over 128 tokens, and the
split MLP pair.

On the CPU the wrappers compute their plain PyTorch versions. Those are held
to (a) the Pallas TPU kernels run in interpret mode on bf16 inputs
(``interpret=True``, ``group=`` given, as tests/test_block_kernels.py runs
them) by ``increment_agreement`` (per-token cosine >= 0.999, max abs error
<= 5% of the reference increment), and (b) the JAX plain references in f32
to 1e-5 abs. The split pair's intermediate h is compared too: bf16, max abs
error <= 2 bf16 ulps of max |h|. The CUDA kernels themselves are held to the
plain versions on the card in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wise_tpu.ops import block as J
from wise_tpu_torch.ops import block as K

#: (B, SP, n_valid, D, heads): head_dim 80; a sequence over 128 at head_dim 64
SHAPES = {"hd80": (8, 24, 17, 160, 2), "seq136": (4, 136, 130, 128, 2)}
ACTS = ["gelu", "quick_gelu", "gelu_tanh"]


def _inputs(shape, seed, mlp=False):
    """x ~ N(0, 1); kernels at 1/sqrt(fan_in); biases and the LayerNorm
    offsets N(0, 0.02)."""
    b, sp, _, d, _ = SHAPES[shape]
    rng = np.random.default_rng(seed)

    def w(*s, std=0.02):
        return (std * rng.standard_normal(s)).astype(np.float32)

    x = rng.standard_normal((b, sp, d)).astype(np.float32)
    ln = (1.0 + w(d), w(d))
    f = 4 * d if mlp else d
    first = (d, 4 * d) if mlp else (d, 3 * d)
    return x, ln, (w(*first, std=d ** -0.5), w(first[1]),
                   w(f, d, std=f ** -0.5), w(d))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _jax(arrs, dtype):
    return [jnp.asarray(a, dtype) for a in arrs]


def _np(a):
    return np.asarray(a, np.float32)


def _attn_pair(shape, kind, causal, x, ln, w, jdt, tdt, interpret):
    """(JAX result, port result) of the attention block or its pooled form
    (row 5)."""
    b, _, n_valid, _, heads = SHAPES[shape]
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jln, tln = _jax(ln, jnp.float32), _torch(ln, torch.float32)
    jw, tw = _jax(w, jdt), _torch(w, tdt)
    if kind == "attn":
        if interpret:
            want = J.fused_attn_block(jx, *jln, *jw, heads=heads,
                                      n_valid=n_valid, causal=causal,
                                      interpret=True, group=b // 2)
        else:
            want = J.plain_attn_block(jx, *jln, *jw, heads=heads,
                                      n_valid=n_valid, causal=causal)
        got = K.fused_attn_block(tx, *tln, *tw, heads=heads, n_valid=n_valid,
                                 causal=causal)
    else:
        if interpret:
            want = J.fused_attn_block_pooled(
                jx, *jln, *jw, heads=heads, n_valid=n_valid, pool_row=5,
                causal=causal, interpret=True, group=b)
        else:
            want = J._pooled_block_xla(jx, *jln, *jw, heads, n_valid, 5,
                                       causal)
        got = K.fused_attn_block_pooled(tx, *tln, *tw, heads=heads,
                                        n_valid=n_valid, pool_row=5,
                                        causal=causal)
    return _np(want), got.float().numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["attn", "pooled"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_attention_matches_tpu_kernel_bf16(shape, kind, causal):
    x, ln, w = _inputs(shape, 50)
    want, got = _attn_pair(shape, kind, causal, x, ln, w, jnp.bfloat16,
                           torch.bfloat16, interpret=True)
    assert got.shape == want.shape
    xb = torch.from_numpy(x).to(torch.bfloat16)
    base = xb if kind == "attn" else xb[:, 5]
    check = K.increment_agreement(torch.from_numpy(got),
                                  torch.from_numpy(want), base)
    assert check["ok"], check


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["attn", "pooled"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_attention_matches_jax_reference_f32(shape, kind, causal):
    x, ln, w = _inputs(shape, 51)
    want, got = _attn_pair(shape, kind, causal, x, ln, w, jnp.float32,
                           torch.float32, interpret=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _tpu_fc_half(jx, jln, wfc, bfc, act, group):
    """The first kernel of ``J.fused_mlp_split`` alone in interpret mode:
    the reference's intermediate h, (B, SP, 4D) in x's dtype."""
    import functools

    b, sp, d = jx.shape
    ff = wfc.shape[1]

    def const(shape):
        return pl.BlockSpec(shape, lambda i: tuple(0 for _ in shape),
                            memory_space=pltpu.VMEM)

    return pl.pallas_call(
        functools.partial(J._fc_kernel, act=act),
        grid=(b // group,),
        in_specs=[pl.BlockSpec((group, sp, d), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
                  const((2, d)), const((d, ff)), const((1, ff))],
        out_specs=pl.BlockSpec((group, sp, ff), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, sp, ff), jx.dtype),
        interpret=True,
    )(jx, jnp.stack(jln).astype(jnp.float32), wfc, bfc.reshape(1, -1))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_mlp_split_matches_tpu_kernels_bf16(shape, act):
    """The pair against ``J.fused_mlp_split`` in interpret mode, and each
    half on its own: h against the reference's first kernel, the second
    half on the reference's h."""
    b = SHAPES[shape][0]
    x, ln, w = _inputs(shape, 60 + ACTS.index(act), mlp=True)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    jln, tln = _jax(ln, jnp.float32), _torch(ln, torch.float32)
    jw, tw = _jax(w, jnp.bfloat16), _torch(w, torch.bfloat16)

    want = _np(J.fused_mlp_split(jx, *jln, *jw, act=act, interpret=True,
                                 group=b // 2))
    got = K.fused_mlp_split(tx, *tln, *tw, act=act)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    check = K.increment_agreement(got, torch.from_numpy(want), tx)
    assert check["ok"], check

    want_h = _np(_tpu_fc_half(jx, jln, jw[0], jw[1], act, b // 2))
    h = K.fused_mlp_fc(tx, *tln, *tw[:2], act=act)
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == want_h.shape
    ulp = float(np.abs(want_h).max()) * 2.0 ** -8  # bf16: 8 significant bits
    assert np.abs(h.float().numpy() - want_h).max() <= 2 * ulp

    out = K.fused_mlp_proj(torch.from_numpy(want_h).bfloat16(), *tw[2:], tx)
    check = K.increment_agreement(out, torch.from_numpy(want), tx)
    assert check["ok"], check


@pytest.mark.parametrize("act", ACTS)
def test_mlp_split_matches_jax_reference_f32(act):
    x, ln, w = _inputs("hd80", 70 + ACTS.index(act), mlp=True)
    tx, tln, tw = (torch.from_numpy(x), _torch(ln, torch.float32),
                   _torch(w, torch.float32))
    want = _np(J.plain_mlp_block(jnp.asarray(x), *_jax(ln, jnp.float32),
                                 *_jax(w, jnp.float32), act=act))
    got = K.fused_mlp_split(tx, *tln, *tw, act=act)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    halves = K.fused_mlp_proj(K.fused_mlp_fc(tx, *tln, *tw[:2], act=act),
                              *tw[2:], tx)
    assert torch.equal(halves, got)
    assert torch.equal(K.fused_mlp_block(tx, *tln, *tw, act=act), got)


def test_increment_check_fails_h_not_activated():
    x, ln, w = _inputs("hd80", 80, mlp=True)
    tx, tln, tw = (torch.from_numpy(x), _torch(ln, torch.float32),
                   _torch(w, torch.float32))
    want = K.plain_mlp_split(tx, *tln, *tw, act="gelu")
    bad = K.plain_mlp_split(tx, *tln, *tw, act="none")
    assert K.increment_agreement(want, want, tx)["ok"]
    assert not K.increment_agreement(bad, want, tx)["ok"]


@pytest.mark.parametrize("fault", ["scale_of_hd64", "tile_dropped"])
def test_increment_check_fails_wide_attention_faults(fault):
    """The faults the card's check plants at the ViT-H/14 shape: logits
    scaled by 1/8 at head_dim 80, and a 64-row query tile left unwritten."""
    shape = "hd80" if fault == "scale_of_hd64" else "seq136"
    _, _, n_valid, d, heads = SHAPES[shape]
    x, ln, w = _inputs(shape, 81)
    tx, tln = torch.from_numpy(x), _torch(ln, torch.float32)
    kw = dict(heads=heads, n_valid=n_valid)
    want = K.plain_attn_block(tx, *tln, *_torch(w, torch.float32), **kw)
    if fault == "scale_of_hd64":
        wqkv, bqkv = w[0].copy(), w[1].copy()
        # a sharper softmax than the card's rows use, so that the tiny
        # shape's 17 keys tell the two scales apart
        wqkv[:, :d] *= 3.0
        want = K.plain_attn_block(tx, *tln, *_torch((wqkv, bqkv, *w[2:]),
                                                    torch.float32), **kw)
        wqkv[:, :d] *= 0.125 * (d // heads) ** 0.5
        bqkv[:d] *= 0.125 * (d // heads) ** 0.5
        bad = K.plain_attn_block(tx, *tln, *_torch((wqkv, bqkv, *w[2:]),
                                                   torch.float32), **kw)
    else:
        bad = want.clone()
        bad[:, 64:128] = tx[:, 64:128]
    assert K.increment_agreement(want, want, tx)["ok"]
    assert not K.increment_agreement(bad, want, tx)["ok"]


@pytest.mark.parametrize("seq,width,want", [
    (50, 768, "single"), (77, 512, "single"), (197, 768, "single"),
    (257, 1024, "split"), (257, 1280, "split"), (77, 1024, "split")])
def test_mlp_choice(seq, width, want):
    """``seq`` names the published tower; the choice goes by width alone."""
    assert K.mlp_choice(width) == want


def test_mlp_choice_is_the_reference_calibration():
    """Every published shape the reference calibrated takes the same kind
    of MLP kernel in the port."""
    for (_, width), (kind, _) in J._CALIBRATED_MLP.items():
        assert kind.replace("flat", "") == K.mlp_choice(width)


@pytest.mark.parametrize("seq,width,heads,ok", [
    (257, 1280, 16, True),    # ViT-H/14 vision: head_dim 80
    (197, 768, 12, True),     # ViT-B/16 vision
    (77, 1024, 16, True),     # ViT-H/14 text
    (272, 1280, 16, True),    # the longest sequence: K and V resident
    (257, 1152, 16, False),   # head_dim 72
    (273, 1280, 16, False),   # over the resident K and V
    (0, 768, 12, False),
    (50, 770, 12, False)])
def test_wide_gate(seq, width, heads, ok):
    assert K.supports_fused_block(seq, width, heads) is ok


def test_cpu_wrappers_launch_no_kernel():
    K.reset_launches()
    x, ln, w = _inputs("hd80", 90, mlp=True)
    K.fused_mlp_split(torch.from_numpy(x), *_torch(ln, torch.float32),
                      *_torch(w, torch.float32))
    assert not any(K.LAUNCHES.values())
    # the pair launches nothing of its own: only its halves have a count
    assert {"fused_mlp_fc", "fused_mlp_proj"} <= set(K.LAUNCHES)
    assert "fused_mlp_split" not in K.LAUNCHES
