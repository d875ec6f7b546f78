"""doctor CLI: environment / deployment diagnostics.

    python -m wise_tpu_torch.cli.doctor [--project-dir P]

Checks the native decoder, torch and the card (a Hopper H100: compute
capability 9.0), a small product on the device the port's entry points run
on (``utils/device.py``: the card unless WISE_TORCH_DEVICE says otherwise),
``nvcc`` and a load of the port's kernel library (``ops/build.py``, built at
first use), sqlite FTS5, OpenCV, and (optionally) a project's assets,
printing one PASS/FAIL line per check. The exit code is 0 when every line
passes, else 1.

Port of ``wise_tpu/cli/doctor.py``: its JAX device lines become the torch,
card and kernel lines.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys


def check(name, fn):
    try:
        detail = fn()
        print(f"PASS  {name}{': ' + str(detail) if detail else ''}")
        return True
    except Exception as e:
        print(f"FAIL  {name}: {type(e).__name__}: {e}")
        return False


def native():
    from ..io import native_decoder

    if not native_decoder.available():
        raise RuntimeError("libwisedecoder.so missing and build failed")
    lib = native_decoder.get_lib()
    lib.wise_decoder_version.restype = ctypes.c_char_p
    return lib.wise_decoder_version().decode()


def cuda_devices():
    """torch's version and the cards: their count, the first's name, and
    compute capability 9.0, the only target the kernels are built for
    (sm_90a)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(f"torch {torch.__version__}: no CUDA device "
                           "(torch.cuda.is_available() is False)")
    major, minor = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"{name} has compute capability {major}.{minor}; "
                           "the kernels are built for sm_90a (9.0)")
    return (f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
            f"{torch.cuda.device_count()} x {name}, compute capability 9.0")


def device_compute():
    import torch

    from ..utils.device import default_device

    dev = default_device()
    a = torch.ones((128, 128), device=dev)
    r = float((a @ a).sum())
    assert r == 128 ** 3, r
    return f"matmul ok on {dev}"


def nvcc():
    from ..ops.build import find_nvcc

    path = find_nvcc()
    out = subprocess.run([path, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    release = [ln for ln in out.splitlines() if "release" in ln]
    return f"{path}: {release[-1].strip() if release else out.strip()}"


def kernel_library():
    from ..ops import build

    lib = build.load_library()
    missing = [n for n in build.SIGNATURES if not hasattr(lib, n)]
    if missing:
        raise RuntimeError(f"entry points missing: {missing}")
    return (f"{build.library_path().name}: {len(build.SIGNATURES)} entry "
            f"points")


def fts5():
    import sqlite3

    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE VIRTUAL TABLE t USING fts5(a)")
    return "sqlite FTS5 available"


def opencv():
    import cv2

    return f"OpenCV {cv2.__version__}"


def project_checks(project_dir):
    def project():
        from ..project import WiseProject

        proj = WiseProject(project_dir)
        assets = proj.discover_assets()
        n = sum(len(v) for k, v in assets.items() if k != "metadata")
        return (f"{n} feature assets, {len(assets['metadata'])} metadata "
                f"tables")

    def db():
        from .. import db as wdb
        from ..db.repository import get_counts
        from ..project import WiseProject

        proj = WiseProject(project_dir)
        conn = wdb.connect(proj.db_path, readonly=True)
        return get_counts(conn)

    return [("project assets", project), ("project db", db)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="doctor", description=__doc__)
    p.add_argument("--project-dir", default=None)
    args = p.parse_args(argv)
    checks = [("native FFmpeg decoder", native),
              ("cuda devices", cuda_devices),
              ("device compute", device_compute),
              ("nvcc", nvcc),
              ("kernel library", kernel_library),
              ("sqlite FTS5", fts5),
              ("opencv", opencv)]
    if args.project_dir:
        checks += project_checks(args.project_dir)
    ok = True
    for name, fn in checks:
        ok &= check(name, fn)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
