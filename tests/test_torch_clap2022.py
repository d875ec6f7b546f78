"""The port's msclap 2022 towers (CNN14 audio, BERT caption) against the JAX
package's, and the two faults the port repairs.

One flax parameter tree, drawn with numpy from a seed in the shapes of the
JAX CLAP (BERT 2 layers x 32, 4 heads; CNN14 channels (4, 8, 8, 8, 8, 16)
over 64 mel bins; BN affines away from the identity), drives both packages
through ``from_flax_params``. Tolerances:

- f32: 2e-4 abs on tower outputs and embeddings (the README's torch-parity
  bar); bf16: per-row cosine >= 0.9999 (the two frameworks round the GELU,
  the pools and the products at other points);
- CNN14 runs every convolution as the reference does, so the port's conv
  outputs through block 6's second convolution are held to the JAX tower's
  own (``capture_intermediates``). After it the port follows upstream PANNs
  (block 6 without its 2x2 pool, ROADMAP C 1): the tail is held to a numpy
  transcription of upstream ``Cnn14.forward``, and the JAX tower's output
  must differ;
- the BERT tokenizer against ``transformers.BertTokenizer`` on a tiny
  vocabulary with CJK and control characters (ROADMAP C 2: the JAX copy
  must differ there).
"""

import dataclasses
import functools
import logging
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wise_tpu.models.clap import convert as JConv
from wise_tpu.models.clap import model as JM
from wise_tpu.models.clap import tokenizer as JTok
from wise_tpu_torch.models.clap import config as TC
from wise_tpu_torch.models.clap import model as TM
from wise_tpu_torch.models.clap import tokenizer as TTok
from wise_tpu_torch.models.clap.convert import (from_flax_params,
                                                load_msclap_state_dict)

TINY = dict(joint_dim=24, n_mels=64, cnn14_channels=(4, 8, 8, 8, 8, 16),
            vocab_size=97, context_length=16, text_width=32, text_heads=4,
            text_layers=2, text_max_positions=64)
CHANNELS = TINY["cnn14_channels"]


def _jcfg(dtype="float32"):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return dataclasses.replace(JM.get_clap_config("2022"), **TINY, dtype=jdt)


def _tcfg(dtype="float32"):
    return dataclasses.replace(TC.get_clap_config("2022"), **TINY,
                               dtype=dtype)


def _cos(a, b):
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    return ((a * b).sum(-1) / np.linalg.norm(a, axis=-1)
            / np.linalg.norm(b, axis=-1)).min()


@functools.lru_cache(maxsize=None)
def _tree():
    """{'params': ...} in the JAX CLAP's shapes, drawn with numpy: kernels
    at 1/sqrt(fan_in), Dense biases and embeddings N(0, 0.02), LayerNorm
    and BN scales 1 + N(0, 0.2), their offsets N(0, 0.2), the bn0 affine
    near (1/40, 1)."""
    shapes = jax.eval_shape(
        JM.CLAP(_jcfg()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64)), jnp.zeros((1, 16), jnp.int32),
        jnp.ones((1,), jnp.int32))
    rng = np.random.default_rng(2022)

    def draw(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        last = name.rsplit("/", 1)[-1]
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if last == "kernel":
            return n / np.float32(math.sqrt(np.prod(leaf.shape[:-1])))
        if last == "bn0_scale":
            return (1 + 0.1 * n) / 40
        if last == "bn0_bias":
            return 1 + 0.1 * n
        if last == "logit_scale":
            return np.float32(math.log(1 / 0.07))
        if last == "scale" or last.endswith("_scale"):
            return 1 + 0.2 * n
        if last.endswith("_bias") or "ln" in name or "layer_norm" in name:
            return 0.2 * n
        return 0.02 * n

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(dtype="float32"):
    tm = TM.CLAP(_tcfg(dtype))
    tm.load_state_dict(from_flax_params(_tree()))
    return tm.eval().requires_grad_(False)


def _text():
    rng = np.random.default_rng(7)
    lengths = np.array([16, 9, 3, 12], np.int32)
    tokens = np.zeros((4, 16), np.int32)
    for r, n in enumerate(lengths):
        tokens[r, :n] = rng.integers(5, 97, n)
    return tokens, lengths


def _mel(frames=128, batch=3, seed=1):
    rng = np.random.default_rng(seed)
    return (10 * rng.standard_normal((batch, frames, 64)) - 30).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


# --------------------------------------------------------------- BERT ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_tower_matches_jax(dtype):
    tokens, lengths = _text()
    want = np.asarray(JM.BertCaptionEncoder(_jcfg(dtype)).apply(
        {"params": _tree()["params"]["caption_encoder"]},
        jnp.asarray(tokens), jnp.asarray(lengths)))
    got = _port(dtype).caption_encoder(_t(tokens), _t(lengths)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    else:
        assert _cos(got, want) >= 0.9999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_embedding_does_not_change_with_padding(dtype):
    """The additive pad mask: [PAD] after [SEP] is never read, so a
    caption's embedding is the same padded to 7 or to 16 tokens."""
    tokens, lengths = _text()
    tower = _port(dtype).caption_encoder
    short = tower(_t(tokens[2:3, :7]), _t(lengths[2:3])).numpy()
    long_ = tower(_t(tokens[2:3]), _t(lengths[2:3])).numpy()
    junk = tokens[2:3].copy()
    junk[0, 3:] = 50  # pad rows holding other ids
    other = tower(_t(junk), _t(lengths[2:3])).numpy()
    np.testing.assert_allclose(short, long_, atol=1e-5, rtol=0)
    np.testing.assert_allclose(other, long_, atol=1e-5, rtol=0)


# -------------------------------------------------------------- CNN14 ----

def _port_convs(tower, mel):
    """The port tower's output and each convolution's output, (B, T, F, C)
    as the reference lays it out."""
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: seen.__setitem__(
            name, out.permute(0, 2, 3, 1).float().numpy()))
        for name, m in tower.named_children() if name.endswith(("_conv1",
                                                                 "_conv2"))]
    try:
        with torch.no_grad():
            out = tower(torch.from_numpy(mel)).numpy()
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def _jax_convs(mel, dtype="float32"):
    out, state = JM.Cnn14Encoder(_jcfg(dtype)).apply(
        {"params": _tree()["params"]["audio_encoder"]}, jnp.asarray(mel),
        capture_intermediates=True)
    inter = state["intermediates"]
    return np.asarray(out), {
        name: np.asarray(v["__call__"][0], np.float32)
        for name, v in inter.items() if name.startswith("conv_block")}


@pytest.mark.parametrize("frames", [128, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cnn14_convolutions_match_jax(frames, dtype):
    mel = _mel(frames)
    _, got = _port_convs(_port(dtype).audio_encoder, mel)
    _, want = _jax_convs(mel, dtype)
    assert sorted(got) == sorted(want) and len(got) == 12
    for name in want:
        assert got[name].shape == want[name].shape, name
        if dtype == "float32":
            np.testing.assert_allclose(got[name], want[name], atol=2e-4,
                                       rtol=0, err_msg=name)
        else:
            assert _cos(got[name], want[name]) >= 0.9999, name


def _panns_tail(x, bn_scale, bn_bias, fc1_kernel, fc1_bias):
    """Upstream PANNs ``Cnn14.forward`` from conv_block6's second
    convolution on, in numpy, x (B, C, T, F) as torch lays it out:

        x = F.relu_(self.bn2(self.conv2(x)))       # ConvBlock.forward
        x = F.avg_pool2d(x, kernel_size=(1, 1))    # conv_block6: (1, 1)
        x = torch.mean(x, dim=3)
        (x1, _) = torch.max(x, dim=2)
        x2 = torch.mean(x, dim=2)
        x = x1 + x2
        x = F.relu_(self.fc1(x))

    with the inference BatchNorm as its folded affine."""
    x = np.maximum(x * bn_scale[None, :, None, None]
                   + bn_bias[None, :, None, None], 0)
    x = x.mean(axis=3)
    x = x.max(axis=2) + x.mean(axis=2)
    return np.maximum(x @ fc1_kernel + fc1_bias, 0)


@pytest.mark.parametrize("frames", [128, 100])
def test_cnn14_tail_is_upstream_panns(frames):
    """After block 6's second convolution the port is upstream's tower
    (C 1, no pool); the JAX tower, which pools, gives another output."""
    mel = _mel(frames)
    p = _tree()["params"]["audio_encoder"]
    got, convs = _port_convs(_port().audio_encoder, mel)
    x6 = convs["conv_block6_conv2"].transpose(0, 3, 1, 2)  # (B, C, T, F)
    want = _panns_tail(x6, np.asarray(p["conv_block6_bn2_scale"]),
                       np.asarray(p["conv_block6_bn2_bias"]),
                       np.asarray(p["fc1"]["kernel"]),
                       np.asarray(p["fc1"]["bias"]))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    jax_out, _ = _jax_convs(mel)
    assert np.abs(jax_out - got).max() > 1e-2


def test_cnn14_block6_map_at_full_length():
    """690 mel frames (5 s at 44.1 kHz, hop 320) x 64 bins end at 21 x 2
    after block 6, as in upstream PANNs; the reference's extra pool would
    leave 10 x 1."""
    c = dataclasses.replace(_tcfg(), cnn14_channels=(1, 1, 1, 1, 1, 2))
    tower = TM.Cnn14Encoder(c)
    mel = _mel(690, batch=1)
    out, convs = _port_convs(tower, mel)
    assert convs["conv_block6_conv2"].shape == (1, 21, 2, 2)
    assert out.shape == (1, 2)


def test_random_init_keeps_the_bn_affines():
    """init_random_ leaves every folded-BN affine at scale 1, bias 0 and
    bn0 at (1/40, 1); kernels at lecun-normal (a conv's fan-in 3 x 3 x in),
    so a full-depth bf16 tower keeps a live signal."""
    c = dataclasses.replace(TC.get_clap_config("2022"), dtype="bfloat16",
                            cnn14_channels=(8, 16, 16, 32, 32, 64),
                            text_layers=2, text_width=64, text_heads=4)
    model = TM.init_random_(TM.CLAP(c), seed=0)
    enc = model.audio_encoder
    for i in range(1, 7):
        for j in (1, 2):
            scale = getattr(enc, f"conv_block{i}_bn{j}_scale")
            assert torch.equal(scale, torch.ones_like(scale))
            assert not getattr(enc, f"conv_block{i}_bn{j}_bias").any()
    assert torch.allclose(enc.bn0_scale, torch.full((64,), 1 / 40))
    assert torch.equal(enc.bn0_bias, torch.ones(64))
    k = enc.conv_block3_conv1.kernel.float()
    assert abs(k.std().item() * math.sqrt(9 * 16) - 1) < 0.1
    with torch.no_grad():
        feats = enc(torch.from_numpy(_mel(128, batch=2)))
    assert torch.isfinite(feats).all() and (feats > 0).any()


# ---------------------------------------------------------- the model ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_clap_2022_matches_jax(dtype):
    """encode_text whole; encode_audio on what C 1 leaves alone: the JAX
    projection head and normalisation applied to the port's tower
    output."""
    tokens, lengths = _text()
    mel = _mel()
    jm = JM.CLAP(_jcfg(dtype))
    tm = _port(dtype)
    want_t = np.asarray(jm.apply(_tree(), jnp.asarray(tokens),
                                 jnp.asarray(lengths),
                                 method=JM.CLAP.encode_text))
    got_t = tm.encode_text(_t(tokens), _t(lengths)).numpy()
    feats = tm.audio_encoder(torch.from_numpy(mel))
    want_a = np.asarray(jm.apply(
        _tree(), jnp.asarray(feats.numpy()),
        method=lambda m, f: m.audio_projection(f)))
    want_a = want_a / np.linalg.norm(want_a, axis=-1, keepdims=True)
    got_a = tm.encode_audio(torch.from_numpy(mel)).numpy()
    assert got_t.shape == (4, 24) and got_a.shape == (3, 24)
    np.testing.assert_allclose(np.linalg.norm(got_a, axis=-1), 1, atol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(got_t, want_t, atol=2e-4, rtol=0)
        np.testing.assert_allclose(got_a, want_a, atol=2e-4, rtol=0)
    else:
        assert _cos(got_t, want_t) >= 0.9999
        assert _cos(got_a, want_a) >= 0.9999


def test_full_width_2022_config():
    c = TC.get_clap_config("2022")
    assert (c.audio_encoder_type, c.text_encoder_type) == ("cnn14", "bert")
    assert c.cnn14_channels == (64, 128, 256, 512, 1024, 2048)
    assert (c.vocab_size, c.context_length, c.text_width, c.text_heads,
            c.text_layers, c.text_act, c.text_ln_eps) == (
        30522, 100, 768, 12, 12, "gelu", 1e-12)
    assert int(c.sample_rate * c.duration) == 220500
    j = JM.get_clap_config("2022")
    for f in dataclasses.fields(c):
        if hasattr(j, f.name) and f.name != "dtype":
            assert getattr(j, f.name) == getattr(c, f.name), f.name
    prod = TC.production_clap_config("2022")
    assert prod.dtype == "bfloat16" and prod.cnn14_channels[-1] == 2048
    with torch.device("meta"):
        model = TM.CLAP(prod)
    n = sum(p.numel() for p in model.audio_encoder.parameters())
    assert model.audio_encoder.fc1.kernel.shape == (2048, 2048)
    assert model.audio_projection.linear1.kernel.shape == (2048, 1024)
    assert model.caption_encoder.position_embeddings.shape == (512, 768)
    assert 79e6 < n < 81e6  # PANNs Cnn14 without its AudioSet head


# ------------------------------------------------------ the checkpoint ----

def _msclap_2022_state_dict():
    """A synthetic msclap 2022 state dict with the published key set for
    the tiny shapes: transformers' BertModel under caption_encoder.base
    (pooler included), PANNs Cnn14 under audio_encoder.base (the STFT and
    mel buffers, bn0, the conv blocks with live BN statistics, fc1 and the
    AudioSet head), both projections and logit_scale."""
    transformers = pytest.importorskip("transformers")
    c = _tcfg()
    hf = transformers.BertConfig(
        vocab_size=c.vocab_size, hidden_size=c.text_width,
        num_hidden_layers=c.text_layers, num_attention_heads=c.text_heads,
        intermediate_size=4 * c.text_width,
        max_position_embeddings=c.text_max_positions,
        type_vocab_size=c.text_type_vocab, layer_norm_eps=c.text_ln_eps)
    torch.manual_seed(0)
    sd = {f"caption_encoder.base.{k}": v for k, v in
          transformers.BertModel(hf, add_pooling_layer=True).state_dict()
          .items()}
    g = torch.Generator().manual_seed(1)

    def r(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    a = "audio_encoder.base."
    sd[a + "spectrogram_extractor.stft.conv_real.weight"] = r(513, 1, 1024)
    sd[a + "spectrogram_extractor.stft.conv_imag.weight"] = r(513, 1, 1024)
    sd[a + "logmel_extractor.melW"] = r(513, 64)

    def bn(prefix, n):
        sd[prefix + ".weight"] = r(n, scale=0.2, shift=1.0)
        sd[prefix + ".bias"] = r(n, scale=0.2)
        sd[prefix + ".running_mean"] = r(n, scale=0.3)
        sd[prefix + ".running_var"] = torch.rand(n, generator=g) + 0.5
        sd[prefix + ".num_batches_tracked"] = torch.tensor(100)

    bn(a + "bn0", 64)
    cin = 1
    for i, ch in enumerate(CHANNELS):
        for j in (1, 2):
            sd[f"{a}conv_block{i + 1}.conv{j}.weight"] = r(
                ch, cin, 3, 3, scale=1 / math.sqrt(9 * cin))
            bn(f"{a}conv_block{i + 1}.bn{j}", ch)
            cin = ch
    sd[a + "fc1.weight"] = r(16, 16, scale=0.25)
    sd[a + "fc1.bias"] = r(16, scale=0.02)
    sd[a + "fc_audioset.weight"] = r(527, 16)
    sd[a + "fc_audioset.bias"] = r(527)
    for tower, d_in in (("caption_encoder", 32), ("audio_encoder", 16)):
        p = f"{tower}.projection."
        sd[p + "linear1.weight"] = r(24, d_in, scale=1 / math.sqrt(d_in))
        sd[p + "linear1.bias"] = r(24, scale=0.02)
        sd[p + "linear2.weight"] = r(24, 24, scale=1 / math.sqrt(24))
        sd[p + "linear2.bias"] = r(24, scale=0.02)
        sd[p + "layer_norm.weight"] = r(24, scale=0.1, shift=1.0)
        sd[p + "layer_norm.bias"] = r(24, scale=0.1)
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    return sd


def test_msclap_2022_checkpoint_round_trip(caplog):
    """load_msclap_state_dict gives the port's state_dict exactly (every
    key, every shape, strict load), each tensor maps back onto its msclap
    source (transposed, permuted or the BN folded), the JAX converter's
    tree agrees, and the two packages embed alike on it; the HTSAT
    warning stays HTSAT-only."""
    sd = _msclap_2022_state_dict()
    c = _tcfg()
    with caplog.at_level(logging.WARNING):
        state = load_msclap_state_dict(sd, c)
    assert not [r for r in caplog.records if "HTSAT" in r.getMessage()]
    model = TM.CLAP(c)
    ref = model.state_dict()
    assert set(state) == set(ref)
    assert all(state[k].shape == ref[k].shape for k in ref)
    model.load_state_dict(state, strict=True)

    b, a = "caption_encoder.base.", "audio_encoder.base."
    np.testing.assert_array_equal(state["caption_encoder.word_embeddings"],
                                  sd[b + "embeddings.word_embeddings.weight"])
    np.testing.assert_array_equal(
        state["caption_encoder.layer_1.key.kernel"].T,
        sd[b + "encoder.layer.1.attention.self.key.weight"])
    np.testing.assert_array_equal(
        state["caption_encoder.layer_0.out_ln.scale"],
        sd[b + "encoder.layer.0.output.LayerNorm.weight"])
    np.testing.assert_array_equal(
        state["audio_encoder.conv_block4_conv2.kernel"].permute(3, 2, 0, 1),
        sd[a + "conv_block4.conv2.weight"])
    bn_w, bn_b, mean, var = (sd[f"{a}conv_block2.bn1.{n}"] for n in (
        "weight", "bias", "running_mean", "running_var"))
    scale = bn_w / torch.sqrt(var + 1e-5)
    torch.testing.assert_close(state["audio_encoder.conv_block2_bn1_scale"],
                               scale)
    torch.testing.assert_close(state["audio_encoder.conv_block2_bn1_bias"],
                               bn_b - mean * scale)
    np.testing.assert_array_equal(state["audio_encoder.fc1.kernel"].T,
                                  sd[a + "fc1.weight"])
    np.testing.assert_array_equal(
        state["audio_projection.linear2.kernel"].T,
        sd["audio_encoder.projection.linear2.weight"])

    jtree = JConv.convert_msclap_state_dict(
        {k: v.numpy() for k, v in sd.items()}, _jcfg())
    jstate = from_flax_params(jtree)
    assert set(jstate) == set(state)
    for k in state:
        torch.testing.assert_close(jstate[k], state[k], rtol=0, atol=0)

    tokens, lengths = _text()
    mel = _mel()
    jm = JM.CLAP(_jcfg())
    model.eval().requires_grad_(False)
    np.testing.assert_allclose(
        model.encode_text(_t(tokens), _t(lengths)).numpy(),
        np.asarray(jm.apply({"params": jtree}, jnp.asarray(tokens),
                            jnp.asarray(lengths),
                            method=JM.CLAP.encode_text)), atol=2e-4)
    _, convs = _port_convs(model.audio_encoder, mel)
    _, state_j = JM.Cnn14Encoder(_jcfg()).apply(
        {"params": jtree["audio_encoder"]}, jnp.asarray(mel),
        capture_intermediates=True)
    np.testing.assert_allclose(
        convs["conv_block6_conv2"],
        np.asarray(state_j["intermediates"]["conv_block6_conv2"]["__call__"]
                   [0]), atol=2e-4)


# ---------------------------------------------------------- tokenizer ----

TINY_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "dog", "##s", "bark", "##ing", "cat", "a", "sound", "of",
    "cafe", "rain", ",", "!", ".", "'", "\u4e2d", "\u6587", "\u72d7",
    "\u53eb",
]

C2_TEXTS = [
    "\u72d7\u53eb",                     # CJK without spaces
    "the dog\u4e2d\u6587bark",          # CJK inside a word
    "a\x00 dog\u200bs bark\x07ing",     # NUL, zero-width space, BEL dropped
    "rain\u3000of\u00a0cafe",           # ideographic and no-break spaces
    "the\tdog\nbark\r!",                # tab, newline, return as spaces
    "cat\ufffd cat",                     # U+FFFD dropped
]
PLAIN_TEXTS = [
    "the dogs barking",
    "a Café sound, of rain!",
    "unknownword barking cats",
    "the dog " * 20,
    "",
]


@pytest.fixture
def vocab(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(TINY_VOCAB) + "\n", encoding="utf-8")
    return path


@pytest.mark.parametrize("text", C2_TEXTS + PLAIN_TEXTS)
def test_bert_tokenizer_matches_transformers(vocab, text):
    transformers = pytest.importorskip("transformers")
    ours = TTok.BertCaptionTokenizer(vocab, context_length=10)
    ref = transformers.BertTokenizer(str(vocab), do_lower_case=True)
    tokens, lengths = ours([text])
    enc = ref(text, max_length=10, padding="max_length", truncation=True)
    assert tokens[0].tolist() == enc["input_ids"]
    assert lengths[0] == sum(enc["attention_mask"])


def test_reference_tokenizer_keeps_c2(vocab):
    """The JAX package's copy lacks HF's CJK split and control-character
    cleaning (C 2): on those texts it gives other ids than the port."""
    ours = TTok.BertCaptionTokenizer(vocab, context_length=10)
    theirs = JTok.BertCaptionTokenizer(vocab, context_length=10)
    differ = [t for t in C2_TEXTS
              if ours([t])[0].tolist() != theirs([t])[0].tolist()]
    assert len(differ) >= 4, differ
    assert all(ours([t])[0].tolist() == theirs([t])[0].tolist()
               for t in PLAIN_TEXTS)


# ---------------------------------------------------------- extractor ----

def test_factory_serves_clap_2022_on_the_cpu(monkeypatch, tmp_path):
    """microsoft/clap/2022/<variant> through the factory on
    WISE_TORCH_DEVICE=cpu, with narrow towers patched into the registry (the
    hash tokenizer needs the full vocabulary): 48 kHz segments tiled to
    5 s, CNN14, BERT captions with the hash tokenizer, unit f32 outputs."""
    from wise_tpu_torch.models.clap.extractor import ClapExtractor
    from wise_tpu_torch.models.clip.tokenizer import HashTokenizer
    from wise_tpu_torch.models.factory import FeatureExtractorFactory

    monkeypatch.setenv("WISE_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("WISE_CLAP_DTYPE", "float32")
    narrow = dataclasses.replace(TC.get_clap_config("2022"), **{
        **TINY, "vocab_size": 30522, "context_length": 100,
        "text_max_positions": 512})
    monkeypatch.setitem(TC.CLAP_CONFIGS, "2022", narrow)
    fe = FeatureExtractorFactory("microsoft/clap/2022/x")
    assert isinstance(fe, ClapExtractor) and fe.device.type == "cpu"
    assert isinstance(fe.model.audio_encoder, TM.Cnn14Encoder)
    assert isinstance(fe.model.caption_encoder, TM.BertCaptionEncoder)
    assert isinstance(fe.tokenizer, HashTokenizer)
    assert fe.target_samples == 220500
    t = np.arange(2 * 192_000) / 48_000
    segs = np.stack([np.sin(2 * np.pi * f * t[:192_000]) for f in
                     (330.0, 1200.0, 80.0)]).astype(np.float32)
    feats = fe.extract_audio_features(segs)
    assert feats.shape == (3, 24) and feats.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1, atol=1e-5)
    with torch.no_grad():
        mel = fe.log_mel(torch.from_numpy(segs))
        direct = fe.model.encode_audio(mel).numpy()
    assert mel.shape == (3, 690, 64)
    np.testing.assert_allclose(feats, direct, atol=1e-6)
    np.testing.assert_allclose(fe.extract_audio_features(segs[:1]),
                               feats[:1], atol=1e-5)
    txt = fe.extract_text_features(["a dog barking", "violin"])
    assert txt.shape == (2, 24) and not np.allclose(txt[0], txt[1])
    np.testing.assert_allclose(np.linalg.norm(txt, axis=1), 1, atol=1e-5)
    np.testing.assert_allclose(fe.extract_text_features(["violin"])[0],
                               txt[1], atol=1e-5)
