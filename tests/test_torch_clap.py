"""The port's CLAP 2023 towers, log-mel and resample against the JAX
package's.

One parameter tree drives both: the JAX CLAP initialises it (a tiny config:
window 4 over an 8 x 8 patch grid, C 32, two stages, a 2-layer caption
tower of width 128 with 2 heads, context 12) and ``from_flax_params``
carries it onto the port. Tolerances:

- f32: embeddings and tower outputs to 2e-4 abs (the README's torch-parity
  bar; same math, f32 summation order only);
- bf16, the production config (the whole-block HTSAT path in the bf16
  stream, bf16 GEMMs, f32 LayerNorms, the pooled caption layer): the JAX
  towers run the TPU kernels in interpret mode, as tests/test_swin_fused.py
  runs them, and the two frameworks round bf16 at other points, so cosine
  >= 0.9999 per row;
- resample 1e-6 abs; log-mel 0.02 dB where the mel power is above 1e-8
  (f32 DFT GEMMs summed in another order: the error is ~1e-4 dB within
  20 dB of the peak and grows toward the floor, 0.011 dB at 1e-8 here).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wise_tpu.models.clap import model as JM
from wise_tpu.ops import mel as JMel
from wise_tpu.ops import swin_block as JSB
from wise_tpu.ops.resample import resample_linear as j_resample
from wise_tpu_torch.models.clap import config as TC
from wise_tpu_torch.models.clap import model as TM
from wise_tpu_torch.models.clap.convert import (from_flax_params,
                                                load_checkpoint,
                                                load_msclap_state_dict)
from wise_tpu_torch.ops import mel as TMel
from wise_tpu_torch.ops.resample import resample_linear as t_resample

TINY = dict(joint_dim=32, duration=0.5, spec_frames=64, freq_ratio=2,
            n_mels=16, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
            window_size=4, vocab_size=128, context_length=12,
            text_width=128, text_heads=2, text_layers=2)


def _cos(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return ((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
            / np.linalg.norm(b, axis=-1)).min()


@functools.lru_cache(maxsize=None)
def _params():
    jm = JM.CLAP(dataclasses.replace(JM.CLAPConfig(), **TINY))
    return jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 16), jnp.float32),
        jnp.zeros((1, 12), jnp.int32), jnp.ones((1,), jnp.int32)))()


def _data():
    rng = np.random.default_rng(1)
    mel = (10 * rng.standard_normal((3, 70, 16)) - 30).astype(np.float32)
    tokens = rng.integers(0, 128, (3, 12)).astype(np.int32)
    lengths = np.array([3, 12, 1], np.int32)
    return mel, tokens, lengths


@functools.lru_cache(maxsize=None)
def _jax_outputs(dtype, swin_block=True):
    """(audio tower, caption tower, encode_audio, encode_text) of the JAX
    CLAP in its production numerics: pooled caption layer and, in bf16,
    the fused whole-block Swin kernel in interpret mode (``swin_block``;
    else WISE_FUSED_SWIN_BLOCK=0, the window-attention path)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jm = JM.CLAP(dataclasses.replace(JM.CLAPConfig(), **TINY, dtype=jdt,
                                     pool_last_block=True))
    mel, tokens, lengths = map(jnp.asarray, _data())

    def run(p):
        return (jm.apply(p, mel, method=lambda m, x: m.audio_encoder(x)),
                jm.apply(p, tokens, lengths,
                         method=lambda m, t, n: m.caption_encoder(t, n)),
                jm.apply(p, mel, method=JM.CLAP.encode_audio),
                jm.apply(p, tokens, lengths, method=JM.CLAP.encode_text))

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WISE_FUSED_SWIN_BLOCK", "1" if swin_block else "0")
        if dtype == "bfloat16":
            mp.setattr(JSB, "supports_fused_swin_block", lambda *a: True)
            mp.setattr(JSB, "fused_swin_block", functools.partial(
                JSB.fused_swin_block, interpret=True))
        return [np.asarray(o, np.float32) for o in jax.jit(run)(_params())]


def _port(monkeypatch, dtype, **env):
    monkeypatch.setenv("WISE_CLAP_DTYPE", dtype)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = dataclasses.replace(TC.production_clap_config("2023"), **TINY)
    tm = TM.CLAP(cfg).eval()
    tm.load_state_dict(from_flax_params(_params()))   # strict
    return tm


def _port_outputs(tm):
    mel, tokens, lengths = (torch.from_numpy(a) for a in _data())
    with torch.no_grad():
        return [o.float().numpy() for o in (
            tm.audio_encoder(mel), tm.caption_encoder(tokens.long(), lengths),
            tm.encode_audio(mel), tm.encode_text(tokens.long(), lengths))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_towers_match_jax(monkeypatch, dtype):
    """HTSATEncoder, CaptionEncoder (pooled last layer) and the whole
    encode_audio / encode_text through the projections."""
    want = _jax_outputs(dtype)
    got = _port_outputs(_port(monkeypatch, dtype))
    for name, g, w in zip(["audio tower", "caption tower", "encode_audio",
                           "encode_text"], got, want):
        assert g.shape == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=0, err_msg=name)
        else:
            assert _cos(g, w) >= 0.9999, (name, _cos(g, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_path_matches_jax(monkeypatch, dtype):
    """WISE_FUSED_SWIN_BLOCK=0 in both packages: the f32-stream blocks
    around the window-attention op."""
    want = _jax_outputs(dtype, swin_block=False)
    got = _port_outputs(_port(monkeypatch, dtype, WISE_FUSED_SWIN_BLOCK="0"))
    if dtype == "float32":
        np.testing.assert_allclose(got[2], want[2], atol=2e-4, rtol=0)
    else:
        assert _cos(got[2], want[2]) >= 0.9999, _cos(got[2], want[2])


def _jax_module(module, x, dtype=jnp.float32):
    params = module.init(jax.random.PRNGKey(3), x)
    return params, np.asarray(module.apply(params, x), np.float32)


@pytest.mark.parametrize("res,shift", [((8, 8), 0), ((8, 8), 2),
                                       ((4, 4), 2)])
def test_swin_block_matches_jax(res, shift):
    """f32, the f32-stream path; res (4, 4) with window 4 clamps the shift
    to 0 (one window covers the resolution, HTSAT's stage 3)."""
    x = np.random.default_rng(4).standard_normal(
        (2, res[0] * res[1], 32)).astype(np.float32)
    params, want = _jax_module(JM.SwinBlock(32, 2, 4, shift, res),
                               jnp.asarray(x))
    cfg = dataclasses.replace(TC.CLAPConfig(), **TINY)
    tb = TM.SwinBlock(32, 2, 4, shift, res, 4.0, cfg)
    assert tb.shift == (0 if res == (4, 4) else shift)
    tb.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("swin_block", [True, False])
def test_kernel_switch_alone_routes_blocks_to_the_wrappers(monkeypatch,
                                                           swin_block):
    """With fused_block on, a Swin block calls its kernel's wrapper whatever
    its shape (window 12: 144 tokens, more than the kernels take): the
    model never picks the plain version for the card, the wrapper raises
    there instead (tests/test_torch_kernels_cuda.py)."""
    calls = []
    for mod, name in ((TM.SB, "fused_swin_block"),
                      (TM.SA, "fused_window_attention")):
        def spy(*a, _f=getattr(mod, name), _n=name, **kw):
            calls.append(_n)
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    cfg = dataclasses.replace(TC.CLAPConfig(), dtype="bfloat16",
                              fused_block=True, fused_swin_block=swin_block)
    blk = TM.SwinBlock(32, 2, 12, 6, (24, 24), 4.0, cfg)
    with torch.no_grad():
        blk(torch.randn(2, 24 * 24, 32))
    assert calls == ["fused_swin_block" if swin_block
                     else "fused_window_attention"]


def test_patch_merging_and_projection_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    params, want = _jax_module(JM.PatchMerging((8, 8)), jnp.asarray(x))
    tm = TM.PatchMerging(32, (8, 8), torch.float32)
    tm.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want,
                                   atol=2e-5, rtol=0)
    z = rng.standard_normal((3, 64)).astype(np.float32)
    params, want = _jax_module(JM.Projection(32), jnp.asarray(z))
    tp = TM.Projection(64, 32, torch.float32)
    tp.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        np.testing.assert_allclose(tp(torch.from_numpy(z)).numpy(), want,
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(192000, 176400), (48000, 44100),
                                        (100, 37), (37, 100)])
def test_resample_matches_jax(n_in, n_out):
    wav = np.random.default_rng(6).standard_normal((2, n_in)).astype(
        np.float32)
    want = np.asarray(j_resample(jnp.asarray(wav), n_out))
    got = t_resample(torch.from_numpy(wav), n_out).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_log_mel_matches_jax():
    rng = np.random.default_rng(7)
    t = np.arange(44100) / 44100.0
    wav = np.stack([0.3 * np.sin(2 * np.pi * 440 * t),
                    0.1 * rng.standard_normal(44100)]).astype(np.float32)
    wav[0, 20000:21000] = 0.0   # a silent stretch: mel power at the floor
    np.testing.assert_array_equal(
        TMel.mel_filterbank(44100, 1024, 64, 50.0, 14000.0),
        JMel.mel_filterbank(44100, 1024, 64, 50.0, 14000.0))
    want = np.asarray(JMel.log_mel_spectrogram(jnp.asarray(wav)))
    got = TMel.log_mel_spectrogram(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 44100 // 320 + 1, 64)
    live = want > -80.0   # 10 log10(1e-8)
    assert live.mean() > 0.5
    np.testing.assert_allclose(got[live], want[live], atol=0.02, rtol=0)


def test_msclap_checkpoint_loads_like_the_reference(tmp_path):
    """A staged msclap .pth goes through the reference's numpy converter
    onto the port's state_dict, strictly: the same tree as the JAX
    package's load (Linear weights transposed to x @ W, the patch conv to
    HWIO, bn0 folded into the per-bin affine)."""
    from tests.test_clap_convert import _fake_msclap_sd
    from wise_tpu.models.clap.convert import convert_msclap_state_dict

    cfg = dataclasses.replace(TC.CLAPConfig(), **TINY)
    sd = _fake_msclap_sd(cfg)
    torch.save({"model": {k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}}, tmp_path / "clap.pth")
    got = load_checkpoint(tmp_path / "clap.pth", cfg)
    TM.CLAP(cfg).load_state_dict(got)   # strict
    want = from_flax_params(convert_msclap_state_dict(sd, cfg))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    w = sd["audio_encoder.base.layers.0.blocks.1.attn.qkv.weight"]
    assert torch.equal(got["audio_encoder.stage0_block1.attn.qkv.kernel"],
                       torch.from_numpy(w.T.copy()))
    assert load_msclap_state_dict(sd, cfg).keys() == got.keys()
    with pytest.raises(NotImplementedError, match="flax"):
        load_checkpoint(tmp_path / "clap.npz", cfg)


def test_factory_routes_clap_2023_to_the_port(monkeypatch, tmp_path):
    """The production id at full width builds the port's extractor (seeded
    random weights, no JAX); CLAP 2022 raises, naming its ROADMAP item."""
    monkeypatch.setenv("WISE_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    from wise_tpu_torch.models.clap.extractor import ClapExtractor
    from wise_tpu_torch.models.factory import FeatureExtractorFactory

    fe = FeatureExtractorFactory("microsoft/clap/2023/four-datasets")
    assert isinstance(fe, ClapExtractor)
    assert fe.output_dim == 1024 and fe.config == TC.production_clap_config(
        "2023")
    c = fe.config
    assert (c.dtype, c.fused_swin_block, c.pool_last_block) == (
        "bfloat16", True, True)
    # HTSAT stage 3 (res 8, window 8) clamps its shifted block
    assert fe.model.audio_encoder.stage3_block1.shift == 0
    assert fe.model.audio_encoder.stage2_block1.shift == 4
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        FeatureExtractorFactory("microsoft/clap/2022/x")


def test_hash_ids_outside_a_tiny_vocabulary_raise():
    """ROADMAP Queue C 5: under a 3,000-token vocabulary the hash tokenizer
    emits ids outside it; the JAX towers' gather clamps them silently, the
    port's embedding lookup raises."""
    from wise_tpu_torch.models.clip.tokenizer import HashTokenizer

    tokens = HashTokenizer(vocab_size=128, context_length=12)(
        ["a dog barking"])
    assert ((tokens < 0) | (tokens >= 128)).any()
    tm = TM.CLAP(dataclasses.replace(TC.CLAPConfig(), **TINY))
    with pytest.raises(IndexError):
        tm.encode_text(torch.from_numpy(tokens).long(), torch.tensor([5]))
