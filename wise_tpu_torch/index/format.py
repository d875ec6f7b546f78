"""On-disk index format (.widx).

Replaces faiss's ``.faiss`` files (written at
ox-vgg/WISE/src/index/feature_search_index.py:84). Layout:

    magic 'WIDX0001' | uint64 header_len | header JSON | aligned array data

The header describes named arrays (dtype, shape, byte offset), plus free-form
metadata. Arrays are 128-byte aligned so readers can ``np.memmap`` them
directly — index loading is O(1) and the OS page cache handles residency;
feeding a memmap to ``jax.device_put`` streams straight to HBM.

Copy of ``wise_tpu/index/format.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import json
import mmap
from pathlib import Path
from typing import Any, Dict

import numpy as np

MAGIC = b"WIDX0001"
ALIGN = 128


def write_index_file(path, arrays: Dict[str, np.ndarray], metadata: Dict[str, Any]):
    path = Path(path)
    specs = {}
    offset = 0
    order = list(arrays)
    for name in order:
        arr = np.ascontiguousarray(arrays[name])
        arrays[name] = arr
        offset = ((offset + ALIGN - 1) // ALIGN) * ALIGN
        specs[name] = {
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "offset": offset,
        }
        offset += arr.nbytes
    header = json.dumps({"metadata": metadata, "arrays": specs}).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint64(len(header)).tobytes())
        f.write(header)
        data_start = f.tell()
        data_start = ((data_start + ALIGN - 1) // ALIGN) * ALIGN
        for name in order:
            arr = arrays[name]
            pos = data_start + specs[name]["offset"]
            f.seek(pos)
            f.write(arr.tobytes())


class IndexFileWriter:
    """Chunked .widx writer for stores larger than RAM.

    Array dtypes/shapes are declared up front (the header is fixed before
    any data lands); row chunks are then written at arbitrary offsets, so
    index builds can stream source batches sequentially and scatter rows to
    their cell-sorted destinations without materialising the (N, D) matrix.
    Produces byte-identical files to write_index_file given the same data.
    """

    def __init__(self, path, specs: Dict[str, Any], metadata: Dict[str, Any]):
        """specs: {name: (dtype, shape)}; rows are along axis 0."""
        self.path = Path(path)
        self._specs = {}
        offset = 0
        for name, (dtype, shape) in specs.items():
            dtype = np.dtype(dtype)
            offset = ((offset + ALIGN - 1) // ALIGN) * ALIGN
            self._specs[name] = {
                "dtype": dtype.str,
                "shape": list(shape),
                "offset": offset,
            }
            offset += dtype.itemsize * int(np.prod(shape))
        header = json.dumps(
            {"metadata": metadata, "arrays": self._specs}
        ).encode("utf-8")
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        self._f.write(np.uint64(len(header)).tobytes())
        self._f.write(header)
        data_start = self._f.tell()
        self._data_start = ((data_start + ALIGN - 1) // ALIGN) * ALIGN
        # pre-size the file so sparse scatter writes never extend it
        end = self._data_start + offset
        if end > self._f.tell():
            self._f.truncate(end)

    def write_rows(self, name: str, start_row: int, data: np.ndarray):
        spec = self._specs[name]
        dtype = np.dtype(spec["dtype"])
        shape = spec["shape"]
        data = np.ascontiguousarray(data, dtype=dtype)
        row_bytes = dtype.itemsize * int(np.prod(shape[1:])) if len(shape) else 0
        n_rows = data.shape[0] if data.ndim else 1
        if start_row + n_rows > shape[0]:
            raise ValueError(
                f"{name}: rows [{start_row}, {start_row + n_rows}) exceed "
                f"declared shape {shape}"
            )
        self._f.seek(self._data_start + spec["offset"] + start_row * row_bytes)
        self._f.write(data.tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_index_file(path, mmap_arrays: bool = True):
    """Returns (metadata, {name: ndarray}). Arrays are memmapped read-only by
    default."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path} is not a .widx index file")
        (header_len,) = np.frombuffer(f.read(8), dtype=np.uint64)
        header = json.loads(f.read(int(header_len)).decode("utf-8"))
        data_start = f.tell()
        data_start = ((data_start + ALIGN - 1) // ALIGN) * ALIGN
    arrays = {}
    for name, spec in header["arrays"].items():
        dtype = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        abs_offset = data_start + spec["offset"]
        if mmap_arrays:
            arrays[name] = np.memmap(
                path, dtype=dtype, mode="r", offset=abs_offset, shape=shape
            )
        else:
            count = int(np.prod(shape)) if shape else 1
            with open(path, "rb") as f:
                f.seek(abs_offset)
                arrays[name] = np.fromfile(f, dtype=dtype, count=count).reshape(shape)
    return header["metadata"], arrays
