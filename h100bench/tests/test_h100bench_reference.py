"""The plain reference held to the program's plain path (float32, no
kernels) at a tiny size: the three towers and the first training steps.
The test imports both; the reference imports nothing of the program."""

from __future__ import annotations

import dataclasses
import statistics

import pytest
import torch

from conftest import TINY_TEXT, TINY_VISION, _tiny_port_config

from h100bench import frames, reference, weights

SEED = 3_100_000_007
MEAN = [0.48145466, 0.4578275, 0.40821073]
STD = [0.26862954, 0.26130258, 0.27577711]


def _shapes(map_pool: bool):
    v = dict(TINY_VISION, act="gelu_tanh" if map_pool else "gelu",
             pool="map" if map_pool else "cls", ln_eps=1e-5,
             image_mean=MEAN, image_std=STD)
    if map_pool:
        v.update(embed_dim=v["width"], proj="identity")
    t = dict(TINY_TEXT, kind="xlm_roberta", max_positions=514, pad_id=1,
             ln_eps=1e-5, act="gelu", pool="mean", proj="mlp")
    return {"vision": v, "text": t}


def _port(map_pool: bool, pool_last: bool):
    from wise_tpu_torch.models.clip.model import CLIP

    cfg = dataclasses.replace(_tiny_port_config(map_pool), dtype="float32",
                              pool_last_block=pool_last)
    return CLIP(cfg).eval()


@pytest.mark.parametrize("map_pool,pool_last", [
    (False, False), (False, True), (True, False)])
def test_vision_tower(map_pool, pool_last):
    shapes = _shapes(map_pool)
    v = shapes["vision"]
    params = weights.make(weights.vision_spec(v), SEED, "cpu",
                          lambda n, f: torch.float32)
    model = _port(map_pool, pool_last)
    missing, unexpected = model.load_state_dict(params, strict=False)
    assert not unexpected and not [k for k in missing if "visual" in k]
    img = torch.from_numpy(frames.frames(SEED, 4, v["image_size"]))
    x = (img.float() / 255 - torch.tensor(MEAN)) / torch.tensor(STD)
    with torch.no_grad():
        want = model.encode_image(x)
        got = reference.Ref(params, shapes).encode_image(img)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_xlmr_text_tower():
    shapes = _shapes(False)
    t = shapes["text"]
    params = weights.make(weights.text_spec(t), SEED, "cpu",
                          lambda n, f: torch.float32)
    model = _port(False, False)
    missing, unexpected = model.load_state_dict(params, strict=False)
    assert not unexpected and not [k for k in missing if "text" in k]
    tokens = torch.from_numpy(frames.captions(
        SEED, 5, t["context_length"], t["vocab_size"], (4, 12), 1))
    with torch.no_grad():
        want = model.encode_text(tokens)
        got = reference.Ref(params, shapes).encode_text(tokens)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_training_steps():
    from wise_tpu_torch.parallel.train import CLIPTrainer

    shapes = _shapes(False)
    spec = (weights.vision_spec(shapes["vision"])
            + weights.text_spec(shapes["text"]))

    def masters():
        out = weights.make(spec, SEED, "cpu", lambda n, f: torch.float32)
        out["logit_scale"] = weights.logit_scale("cpu")
        return out

    cfg = dataclasses.replace(_tiny_port_config(), dtype="float32")
    trainer = CLIPTrainer(cfg, device="cpu", learning_rate=1e-3,
                          weight_decay=0.01, grad_clip=1.0).init(
        params=masters())
    t, v = shapes["text"], shapes["vision"]
    images = torch.from_numpy(frames.frames(SEED, 24, v["image_size"]))
    images = (images.float() / 255).reshape(3, 8, *images.shape[1:])
    tokens = torch.from_numpy(frames.captions(
        SEED, 24, t["context_length"], t["vocab_size"], (4, 12), 1))
    batches = list(zip(images, tokens.reshape(3, 8, -1)))
    losses, grads = [], None
    for i, (im, tok) in enumerate(batches):
        losses.append(float(trainer.train_step(im, tok)))
        if i == 0:
            st = trainer.optimizer.adamw.state
            grads = weights.leaf_norms(
                {n: st[p]["exp_avg"] for n, p in
                 trainer.model.named_parameters()}, 1 / 0.1)
    ref_params = masters()
    r_losses, r_grads = reference.train_steps(
        ref_params, shapes, batches, 1e-3, 0.01, 1.0)
    assert losses == pytest.approx(r_losses, rel=1e-5)
    med = statistics.median(r_grads.values())
    for n, g in r_grads.items():
        assert abs(grads[n] - g) <= 1e-4 * max(g, med), n
    # elementwise the masters part where a gradient is near nought (AdamW's
    # first steps move such an element by the rate whatever its sign); by
    # leaf, the change's norm agrees
    p0, p = masters(), trainer.params
    change = weights.leaf_norms({n: p[n] - p0[n] for n in p0})
    r_change = weights.leaf_norms({n: ref_params[n] - p0[n] for n in p0})
    # the keys' biases get round-off alone under softmax, which AdamW
    # turns into steps: the rule on the reference's gradient leaves them out
    med_g = statistics.median(r_grads.values())
    still = {n for n, g in r_grads.items() if g < 1e-3 * med_g}
    assert still == {n for n in r_grads if n.endswith("bias.k")}
    med = statistics.median(r_change[n] for n in r_change if n not in still)
    for n, c in r_change.items():
        if n not in still:
            assert c > 0 and abs(change[n] - c) <= 1e-3 * max(c, med), n
