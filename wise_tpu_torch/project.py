"""Project directory layout and asset discovery.

Directory tree (compatible with the reference's WiseProject,
ox-vgg/WISE/src/wise_project.py:6-162):

    <project_dir>/
      store/<creator_ns>/<creator>/<model>/<dataset>/features/<media>-%06d.tar
      store/.../index/<media>-<IndexType>.widx      (our index format)
      store/.../index/<media>-<IndexType>.faiss     (recognised if present)
      media/
      metadata/internal.db                          (sqlite)
      metadata/<folder>/<db>.sqlite                 (imported metadata)
      thumbs.db                                     (sqlite)
      wise.json                                     (central config, ours)

Copy of ``wise_tpu/project.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import Dict

from .config import WiseConfig


class WiseProject:
    MEDIA_TYPE_LIST = ["image", "video", "audio"]

    def __init__(self, project_dir, create_project: bool = False):
        self.project_dir = Path(project_dir)
        self.store_dir = self.project_dir / "store"
        self.media_dir = self.project_dir / "media"
        self.metadata_dir = self.project_dir / "metadata"

        if not self.project_dir.exists():
            if not create_project:
                raise ValueError(f"project folder {self.project_dir} does not exist")
        if create_project:
            for d in (self.store_dir, self.media_dir, self.metadata_dir):
                d.mkdir(parents=True, exist_ok=True)

    # -- database paths ----------------------------------------------------
    @property
    def db_path(self) -> Path:
        return self.metadata_dir / "internal.db"

    @property
    def thumbs_db_path(self) -> Path:
        return self.project_dir / "thumbs.db"

    # URI properties kept for reference parity (wise_project.py:23-29)
    @property
    def dburi(self) -> str:
        return f"sqlite+pysqlite:///{self.db_path.absolute()}"

    @property
    def thumbs_uri(self) -> str:
        return f"sqlite+pysqlite:///{self.thumbs_db_path.absolute()}"

    # -- config ------------------------------------------------------------
    @property
    def config_path(self) -> Path:
        return self.project_dir / "wise.json"

    def load_config(self) -> WiseConfig:
        return WiseConfig.load(self.config_path)

    def save_config(self, config: WiseConfig) -> None:
        config.save(self.config_path)

    # -- per-extractor stores ----------------------------------------------
    def features_root(self, feature_extractor_id: str) -> Path:
        return self.store_dir / feature_extractor_id

    def features_dir(self, feature_extractor_id: str) -> Path:
        return self.features_root(feature_extractor_id) / "features"

    def create_features_dir(self, feature_extractor_id: str) -> Path:
        d = self.features_dir(feature_extractor_id)
        d.mkdir(parents=True, exist_ok=True)
        return d

    def index_dir(self, feature_extractor_id: str) -> Path:
        return self.features_root(feature_extractor_id) / "index"

    def create_index_dir(self, feature_extractor_id: str) -> Path:
        d = self.index_dir(feature_extractor_id)
        d.mkdir(parents=True, exist_ok=True)
        return d

    # -- metadata DBs ------------------------------------------------------
    def metadata_db_table(self, metadata_id: str, extension: str = ".sqlite"):
        """``metadata_id`` is 'FOLDER_NAME/DB_NAME/TABLE_NAME'."""
        tok = metadata_id.split("/")
        if len(tok) != 3:
            raise ValueError(
                'metadata_id must be in "FOLDER_NAME/DB_NAME/TABLE_NAME" format'
            )
        metadata_db_dir = self.metadata_dir / tok[0]
        metadata_db_dir.mkdir(parents=True, exist_ok=True)
        return metadata_db_dir / (tok[1] + extension), tok[2]

    # -- discovery ---------------------------------------------------------
    def discover_assets(self) -> Dict:
        """Walk the store tree and return
        {media_type: {feature_extractor_id: {features_root, features_dir,
        features_files, index_dir, index_files}}} plus a "metadata" section —
        the same shape the reference produces (wise_project.py:67-162).
        """
        assets: Dict = {}
        for feature_dir in self.store_dir.glob("*/*/*/*/features/"):
            feature_extractor_id = str(feature_dir.relative_to(self.store_dir).parent)
            media_types = []
            for f in feature_dir.glob("*.*"):
                mt = f.stem.split("-")[0]
                if mt not in media_types:
                    media_types.append(mt)
            for mt in media_types:
                assets.setdefault(mt, {}).setdefault(feature_extractor_id, {})

        for media_type in assets:
            for feid, entry in assets[media_type].items():
                features_root = self.store_dir / feid
                features_dir = features_root / "features"
                index_dir = features_root / "index"
                entry["features_root"] = str(features_root)
                entry["features_dir"] = str(features_dir)
                entry["features_files"] = sorted(
                    f.name for f in features_dir.glob(media_type + "-*.*")
                )
                entry["index_dir"] = str(index_dir)
                entry["index_files"] = []
                if index_dir.exists():
                    names = set()
                    for pat in (media_type + "-*.faiss", media_type + "-*.widx"):
                        names.update(f.name for f in index_dir.glob(pat))
                    entry["index_files"] = sorted(names)

        assets["metadata"] = {}
        for metadata_db in self.metadata_dir.glob("*/*.sqlite"):
            rel = metadata_db.relative_to(self.metadata_dir)
            prefix = str(rel.parent / rel.stem)
            with sqlite3.connect(str(metadata_db)) as conn:
                rows = conn.execute(
                    "SELECT name FROM sqlite_master WHERE type='table'"
                ).fetchall()
            for (table_name,) in rows:
                if "_fts" in table_name:
                    continue
                assets["metadata"][prefix + "/" + table_name] = {
                    "metadata_db": str(metadata_db),
                    "metadata_db_type": "sqlite",
                    "metadata_table": table_name,
                }
        self.assets = assets
        return assets
