"""The training slice end to end: both packages' ``metadata import`` and
``train`` CLIs on one synthetic project, then the port's extractor serving
what the port's trainer wrote.

The project is built once by the port's extract pipeline (both packages read
the same project layout); each package imports the same caption CSV under
its own metadata id and fine-tunes a tiny CLIP (registered in both
registries for the test, vocabulary 4,096 so that the hash tokenizer's ids
fit) for three steps on the CPU. The two trainers draw their initial weights
from different generators, so what is held is what both must do whatever
the weights: the same metadata rows, the same caption segments and batches,
a ``step_00000003`` checkpoint each, resumption, and a checkpoint that loads
and changes the embeddings. The arithmetic of a step is held against the JAX
trainer from one tree in tests/test_torch_train.py.
"""

import dataclasses
import sqlite3

import numpy as np
import pytest
import torch

from tests.media_fixtures import make_video

MODEL = "ViT-TRAINSLICE"
TINY = dict(
    embed_dim=16, image_size=32, patch_size=16, vision_width=32,
    vision_layers=1, vision_heads=2, context_length=8, vocab_size=4096,
    text_width=32, text_heads=2, text_layers=1,
)
CSV = ("uid,vid,start,stop,narration\n"
       "u1,cook,0.0,2.0,frying vegetables\n"
       "u2,cook,2.0,3.9,stirring the pan\n"
       "u3,walk,0.5,2.5,a dog on the beach\n"
       "u4,missing,0.0,1.0,no such file\n")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from wise_tpu.models.clip import model as JM
    from wise_tpu_torch.models.clip import config as TC
    from wise_tpu_torch.pipeline.extract import extract_features

    root = tmp_path_factory.mktemp("train_slice")
    media = root / "m"
    media.mkdir()
    make_video(media / "cook.mp4", seconds=4, fps=10)
    make_video(media / "walk.mp4", seconds=3, fps=10)
    (root / "ann.csv").write_text(CSV)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WISE_TORCH_DEVICE", "cpu")
        mp.setenv("WISE_CHECKPOINT_DIR", str(root / "ckpts"))
        mp.delenv("WISE_PREPROCESS", raising=False)
        mp.setitem(JM.CLIP_CONFIGS, MODEL, JM.CLIPConfig(**TINY))
        mp.setitem(TC.CLIP_CONFIGS, MODEL, TC.CLIPConfig(**TINY))
        fid = "wise/random_features/16/train"
        extract_features([media], root / "p", image_feature_id=fid,
                         video_feature_id=fid, audio_feature_id=fid)
        yield root


def _import_args(root, metadata_id):
    return ["import", "--from-csv", str(root / "ann.csv"),
            "--metadata-id", metadata_id, "--col-metadata-id", "uid",
            "--col-filename", "{vid}.mp4", "--col-starttime", "start",
            "--col-stoptime", "stop", "--col-metadata", "narration",
            "--project-dir", str(root / "p")]


def _train_args(root, metadata_id, ckpt, steps=3, *more):
    return ["--project-dir", str(root / "p"), "--metadata-id", metadata_id,
            "--caption-column", "narration", "--model", MODEL,
            "--steps", str(steps), "--batch-size", "2", "--dtype", "float32",
            "--checkpoint-every", "0", "--checkpoint-dir", str(ckpt), *more]


@pytest.fixture(scope="module")
def drives(env):
    """Both packages' metadata import and three training steps."""
    from wise_tpu.cli.metadata import main as j_metadata
    from wise_tpu.cli.train import main as j_train
    from wise_tpu_torch.cli.metadata import main as t_metadata
    from wise_tpu_torch.cli.train import main as t_train

    assert j_metadata(_import_args(env, "T/jax/train")) == 0
    assert t_metadata(_import_args(env, "T/torch/train")) == 0
    j_ckpt = env / "ckpts" / MODEL / "orbax"
    t_ckpt = env / "ckpts" / MODEL / "ft"
    assert j_train(_train_args(env, "T/jax/train", j_ckpt, 3,
                               "--dp", "2")) == 0
    assert t_train(_train_args(env, "T/torch/train", t_ckpt)) == 0
    return j_ckpt, t_ckpt


def _table(root, metadata_id):
    from wise_tpu_torch.project import WiseProject

    meta = WiseProject(root / "p").discover_assets()["metadata"][metadata_id]
    with sqlite3.connect(meta["metadata_db"]) as conn:
        return conn.execute(
            f"SELECT __filename, __starttime, __stoptime, narration FROM "
            f"{meta['metadata_table']} ORDER BY __metadata_id").fetchall()


def test_metadata_import_writes_the_same_rows(env, drives):
    rows = _table(env, "T/torch/train")
    assert rows == _table(env, "T/jax/train")
    # the row whose file is not in the project is dropped by both
    assert [r[0] for r in rows] == ["cook.mp4", "cook.mp4", "walk.mp4"]


def test_caption_segments_and_batches_are_the_same(env, drives):
    from wise_tpu.pipeline import train_data as J
    from wise_tpu.project import WiseProject as JProject
    from wise_tpu_torch.models.clip.tokenizer import get_tokenizer
    from wise_tpu_torch.pipeline import train_data as T
    from wise_tpu_torch.project import WiseProject

    want = J.load_caption_segments(JProject(env / "p"), "T/jax/train",
                                   "narration")
    got = T.load_caption_segments(WiseProject(env / "p"), "T/torch/train",
                                  "narration")
    assert got == want and len(got) == 3
    tok = get_tokenizer(None, vocab_size=4096, context_length=8)
    for (gi, gt), (wi, wt) in zip(
            T.caption_batches(got, tok, 2, 32, epochs=2),
            J.caption_batches(want, tok, 2, 32, epochs=2)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)
        assert gi.shape == (2, 32, 32, 3) and gi.dtype == np.float32
        assert 0 <= int(gt.min()) and int(gt.max()) < 4096


def test_both_clis_write_a_step_3_checkpoint(drives):
    from wise_tpu_torch.parallel.train import STATE_FILE, checkpoint_steps

    j_ckpt, t_ckpt = drives
    assert [p.name for p in j_ckpt.glob("step_*")] == ["step_00000003"]
    assert [p.name for p in t_ckpt.glob("step_*")] == ["step_00000003"]
    assert (t_ckpt / "step_00000003" / STATE_FILE).is_file()
    assert checkpoint_steps(t_ckpt) == [3]
    assert checkpoint_steps(j_ckpt) == []  # orbax: no torch file inside


def test_checkpoint_holds_the_f32_tree_of_the_reference(drives):
    """The port's checkpoint holds every parameter the JAX trainer's tree
    holds, by the port's key, at the same shape, in f32."""
    import jax

    from wise_tpu.models.clip.model import CLIP, CLIPConfig
    from wise_tpu_torch.models.clip.convert import from_flax_params
    from wise_tpu_torch.parallel.train import restore_train_checkpoint

    step, params, opt_state = restore_train_checkpoint(drives[1])
    assert step == 3 and opt_state["count"] == 3
    shapes = jax.eval_shape(
        CLIP(CLIPConfig(**TINY)).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 32, 32, 3), np.float32),
        jax.ShapeDtypeStruct((1, 8), np.int32))
    want = from_flax_params(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in params.values())


def test_resume_continues_from_the_latest_step(env, drives):
    from wise_tpu_torch.cli.train import main as t_train
    from wise_tpu_torch.parallel.train import checkpoint_steps

    assert t_train(_train_args(env, "T/torch/train", drives[1], 5,
                               "--resume")) == 0
    assert checkpoint_steps(drives[1]) == [3, 5]
    # already at the target: no step runs, and the CLI says so by its code
    assert t_train(_train_args(env, "T/torch/train", drives[1], 5,
                               "--resume")) == 1


def test_extractor_serves_the_fine_tuned_checkpoint(env, drives):
    """The newest ``step_*`` of the port's trainer loads where the JAX
    extractor loads orbax's; the embeddings are those of the checkpoint's
    weights and differ from the seed-0 weights'."""
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.models.clip.model import CLIP
    from wise_tpu_torch.parallel.train import (checkpoint_steps,
                                               restore_train_checkpoint)

    tuned = OpenClipExtractor(f"mlfoundations/open_clip/{MODEL}/ft")
    seeded = OpenClipExtractor(f"mlfoundations/open_clip/{MODEL}/none")
    frames = np.random.default_rng(0).integers(
        0, 256, (3, 32, 32, 3), dtype=np.uint8)
    got = tuned.extract_image_features(frames)
    assert got.shape == (3, 16) and np.all(np.isfinite(got))
    assert np.abs(got - seeded.extract_image_features(frames)).max() > 1e-3
    text = tuned.extract_text_features(["frying vegetables"])
    assert np.abs(
        text - seeded.extract_text_features(["frying vegetables"])).max() > 1e-3

    step, params, _ = restore_train_checkpoint(drives[1])
    assert step == checkpoint_steps(drives[1])[-1]
    model = CLIP(tuned.config)
    model.load_state_dict(params)
    x = tuned.preprocess_frames(torch.from_numpy(frames), 32)
    with torch.no_grad():
        want = model.encode_image(x.float()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_extractor_refuses_an_orbax_checkpoint_by_name(drives):
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor

    with pytest.raises(NotImplementedError, match="orbax"):
        OpenClipExtractor(f"mlfoundations/open_clip/{MODEL}/orbax")


def test_a_trainer_file_is_never_taken_for_an_open_clip_checkpoint(tmp_path):
    from wise_tpu_torch.models.clip.extractor import _find_checkpoint

    (tmp_path / "step_00000003.pt").write_bytes(b"x")
    (tmp_path / "step_00000004").mkdir()
    assert _find_checkpoint(tmp_path) is None
    (tmp_path / "open_clip_model.pt").write_bytes(b"x")
    assert _find_checkpoint(tmp_path).name == "open_clip_model.pt"


@pytest.mark.parametrize("shape", [(224, 224), (180, 320)])
def test_exact_preprocessing_matches_jax(shape):
    """The port's copy of preprocess_images_exact (PIL resize first, then
    the centre crop) gives the JAX package's output bit for bit on seeded
    uint8 frames, square and not."""
    from wise_tpu.models.clip.preprocess import preprocess_images_exact as jx
    from wise_tpu_torch.models.clip.preprocess import (
        preprocess_images_exact as tx)

    frames = np.random.default_rng(sum(shape)).integers(
        0, 256, (3, *shape, 3), dtype=np.uint8)
    got, want = tx(frames, 224), jx(frames, 224)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (3, 224, 224, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tx(frames[0], 224), jx(frames[0], 224))


def test_exact_preprocessing_raises_until_it_is_ported(env, monkeypatch,
                                                       tmp_path):
    """WISE_PREPROCESS=exact routes uint8 frames through the upstream PIL
    path in both packages (the port raised here until it had its copy,
    ROADMAP Queue C 8). One seeded open_clip checkpoint drives both
    extractors in f32: on non-square uint8 frames their embeddings agree to
    tests/test_torch_slice.py's 1.001e-3 and differ from the port's device
    resize (crop first) on the same frames."""
    from tests.test_convert_published_keysets import openclip_clip_keyset
    from wise_tpu.models.clip import model as JM
    from wise_tpu.models.clip.extractor import OpenClipExtractor as JX
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor as TX

    rng = np.random.default_rng(0)
    sd = {k: rng.normal(0.0, 0.02, np.shape(v)).astype(np.float32)
          for k, v in openclip_clip_keyset(JM.CLIPConfig(**TINY)).items()}
    ckpt = tmp_path / MODEL / "exact"
    ckpt.mkdir(parents=True)
    np.savez(ckpt / "open_clip_model.npz", **sd)
    monkeypatch.setenv("WISE_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("WISE_CLIP_DTYPE", "float32")
    fid = f"mlfoundations/open_clip/{MODEL}/exact"
    frames = np.random.default_rng(5).integers(0, 256, (3, 48, 40, 3),
                                               dtype=np.uint8)
    port, ref = TX(fid), JX(fid)
    device_resize = port.extract_image_features(frames)
    monkeypatch.setenv("WISE_PREPROCESS", "exact")
    got = port.extract_image_features(frames)
    want = ref.extract_image_features(frames)
    assert got.shape == want.shape == (3, TINY["embed_dim"])
    np.testing.assert_allclose(got, want, atol=1.001e-3, rtol=0)
    assert not np.allclose(got, device_resize, atol=1e-6)
    # float input is already preprocessed: the variable does not apply
    floats = np.zeros((1, 32, 32, 3), np.float32)
    exact = port.extract_image_features(floats)
    monkeypatch.delenv("WISE_PREPROCESS")
    np.testing.assert_array_equal(exact, port.extract_image_features(floats))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("off", [(), ("WISE_FUSED_BLOCK",),
                                 ("WISE_POOL_LAST",)])
def test_training_clip_config_matches_the_reference(monkeypatch, dtype, off):
    import jax.numpy as jnp

    from wise_tpu.cli.train import training_clip_config as j_config
    from wise_tpu_torch.cli.train import training_clip_config as t_config

    for name in ("WISE_FUSED_BLOCK", "WISE_POOL_LAST", "WISE_FUSED_ATTN"):
        monkeypatch.delenv(name, raising=False)
    for name in off:
        monkeypatch.setenv(name, "0")
    want = dataclasses.asdict(j_config("ViT-B-32", dtype, remat=True))
    got = dataclasses.asdict(t_config("ViT-B-32", dtype, remat=True))
    assert jnp.dtype(want.pop("dtype")).name == got.pop("dtype") == dtype
    # one deliberate deviation (ROADMAP Queue C 10): the port keeps the
    # attention middle a kernel in bf16, as both extractors' production
    # configs do; the reference's training config leaves it off
    assert not want.pop("fused_attention")
    assert got.pop("fused_attention") == (dtype == "bfloat16")
    assert got == {k: want[k] for k in got}
    assert got["fused_block"] == (dtype == "bfloat16"
                                  and "WISE_FUSED_BLOCK" not in off)
    monkeypatch.setenv("WISE_FUSED_ATTN", "0")
    assert not t_config("ViT-B-32", dtype).fused_attention


def test_parsers_take_the_same_options():
    from wise_tpu.cli.train import build_parser as j_parser
    from wise_tpu_torch.cli.train import build_parser as t_parser

    def options(parser):
        return {a.dest: (a.default, tuple(a.option_strings))
                for a in parser._actions}

    assert options(t_parser()) == options(j_parser())
