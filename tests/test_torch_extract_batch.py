"""The port's batched embedder (wise_tpu_torch/pipeline/extract.py) with
frames of two resolutions in one encoder batch.

Each frame is canonicalised through the extractor's ``preprocess_image``
(centre crop, resize to the model's size) before the batch is stacked, so two
videos of different sizes may share a batch. The JAX package's copy
(wise_tpu/pipeline/extract.py) stacks the raw frames first and raises there.
The embeddings of the mixed batch equal those of each video ingested alone.
"""

import numpy as np

from tests.media_fixtures import make_video

FID = "mlfoundations/open_clip/ViT-Test-Tiny/mixed"


def _vectors(project_dir):
    """A project's stored video embeddings in vector-id order (arrival
    order: the files sorted by name, each file's frames by time)."""
    from wise_tpu_torch.project import WiseProject
    from wise_tpu_torch.store.factory import FeatureStoreFactory

    asset = WiseProject(project_dir).discover_assets()["video"][FID]
    store = FeatureStoreFactory.load_store("video", asset["features_dir"])
    store.enable_read()
    pairs = sorted((int(i), np.asarray(f)) for i, f in store)
    return np.concatenate([f.reshape(1, -1) for _, f in pairs])


def test_one_batch_mixes_two_video_resolutions(tmp_path, monkeypatch):
    from wise_tpu_torch.pipeline.extract import extract_features

    monkeypatch.setenv("WISE_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("WISE_CLIP_DTYPE", "float32")
    videos = {"a_small.mp4": (64, 48), "b_large.mp4": (96, 80)}
    both = tmp_path / "both"
    both.mkdir()
    for name, size in videos.items():
        make_video(both / name, seconds=2, fps=10, size=size)
        alone = tmp_path / name.split(".")[0]
        alone.mkdir()
        make_video(alone / name, seconds=2, fps=10, size=size)

    # one batch holds every frame of both videos
    mixed = extract_features([str(both)], tmp_path / "p_both",
                             video_feature_id=FID, image_feature_id=FID,
                             batch_size=256, thumbnails=False)
    assert mixed.num_video_vectors > 2
    singles = [extract_features([str(tmp_path / name.split(".")[0])],
                                tmp_path / f"p_{name.split('.')[0]}",
                                video_feature_id=FID, image_feature_id=FID,
                                batch_size=256, thumbnails=False)
               for name in videos]
    assert mixed.num_video_vectors == sum(s.num_video_vectors
                                          for s in singles)
    alone = np.concatenate([_vectors(tmp_path / f"p_{name.split('.')[0]}")
                            for name in videos])
    np.testing.assert_allclose(_vectors(tmp_path / "p_both"), alone,
                               rtol=0, atol=1e-5)
