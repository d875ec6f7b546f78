"""The port's ``VectorRepo`` (wise_tpu_torch/db/repository.py) against the
JAX package's: ``create_batch`` and the bulk ``insert_rows`` behind it write
the rows the reference's ``create_batch`` writes, under the same contiguous
ids, and read back through ``get`` as they were given."""

import pytest

from wise_tpu import data_models as JDM
from wise_tpu import db as JDB
from wise_tpu.db import repository as JR
from wise_tpu_torch import data_models as DM
from wise_tpu_torch import db as DB
from wise_tpu_torch.db import repository as R

ROWS = [(DM.ModalityType.VIDEO, 1, i / 2, None) for i in range(5)] + [
    (DM.ModalityType.IMAGE, 1, 0.0, 1.5)]


def _project(init, dm, repo, tmp_path, name):
    conn = init(tmp_path / f"{name}.db")
    sc = repo.SourceCollectionRepo().create(conn, dm.SourceCollection(
        location=str(tmp_path), type=dm.SourceCollectionType.DIR))
    repo.MediaRepo().create(conn, dm.MediaMetadata(
        source_collection_id=sc.id, path="a.mp4",
        media_type=dm.MediaType.VIDEO, format="mp4", width=8, height=8,
        num_frames=5, duration=2.5))
    return conn


def _table(conn):
    return conn.execute("SELECT id, modality, media_id, timestamp, "
                        "end_timestamp FROM vectors ORDER BY id").fetchall()


@pytest.mark.parametrize("id_base", [0, 1 << 40])
def test_insert_rows_and_create_batch_write_the_references_rows(tmp_path,
                                                                 id_base):
    want_conn = _project(JDB.init_project, JDM, JR, tmp_path, "jax")
    objs = [JDM.VectorMetadata(modality=m.value, media_id=media, timestamp=t,
                               end_timestamp=e) for m, media, t, e in ROWS]
    JR.VectorRepo().create_batch(want_conn, objs[:3], id_base)
    JR.VectorRepo().create_batch(want_conn, objs[3:], id_base)
    conn = _project(DB.init_project, DM, R, tmp_path, "port")
    repo = R.VectorRepo()
    base = repo.insert_rows(conn, ROWS[:3], id_base)
    made = repo.create_batch(conn, [
        DM.VectorMetadata(modality=m, media_id=media, timestamp=t,
                          end_timestamp=e) for m, media, t, e in ROWS[3:]],
        id_base)
    assert base == id_base
    assert [v.id for v in made] == [id_base + i for i in range(4, 7)]
    got = _table(conn)
    assert got == _table(want_conn)
    for (vid, *_), (m, media, t, e) in zip(got, ROWS):
        v = repo.get(conn, vid)
        assert (v.modality, v.media_id, v.timestamp, v.end_timestamp) == (
            m, media, t, e)
