#!/usr/bin/env python3
"""Time the threshold scan (wise_tpu_torch/csrc/topk_kernels.cu
``topk_scan_kernel``, behind ``fused_topk_threshold``) on one CUDA card,
whole and cut down, to see where its time goes.

    python3 scripts/bench_threshold_scan.py

At 1,048,576 x 512 (seeded unit vectors, f32 and bf16 storage) and Q / k of
1 / 10, 1 / 100, 8 / 10 and 16 / 10, it prints a ``[scan]`` line a shape with
the ms of builds of the kernel compiled from the source with nvcc into
build/bench/ (one library a build, all compiled together):

- ``full``: the source as it is, the merge by the last CTA included;
- ``lists256``: the same build with lists of at least 256 entries (fewer
  flushes);
- ``no_select``: the rows scored, no vote, append or merge;
- ``stream``: the ring alone, the stages waited for and released, nothing
  scored.

``full`` against ``no_select`` prices the selection and the merge,
``no_select`` against ``stream`` the scoring, and ``stream`` against the
bound (the bytes at 3.35 TB/s) the streaming. CUDA events, 10 calls after 3,
after a call of each build held against the plain version on the "full"
build's answer. Needs nvcc and one card.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from wise_tpu_torch.ops import fused_topk as FT  # noqa: E402
from wise_tpu_torch.ops.build import (NVCC_FLAGS, SIGNATURES,  # noqa: E402
                                      find_nvcc)

CSRC = ROOT / "wise_tpu_torch" / "csrc"
OUT = ROOT / "build" / "bench"
N, D = 1 << 20, 512
SHAPES = [(1, 10), (1, 100), (8, 10), (16, 10)]

VOTE = ("  const uint64_t t = *static_cast<volatile uint64_t*>(taus + q);\n"
        "  if (__any_sync(0xffffffffu, key > t))\n"
        "    scan_append(key, lists + q * p, taus + q, cnts + q, locks + q, "
        "k, cap, p,\n                lane, flushes);\n")
# the scores kept alive without the selection: a write no word makes (a
# row's word is never 1)
KEEP = "  if (key == 1ull) cnts[q] = 1;\n"


def variants() -> dict:
    src = (CSRC / "topk_kernels.cu").read_text()
    if src.count(VOTE) != 1:
        raise SystemExit("the scan's source no longer matches this script")
    no_select = src.replace(VOTE, KEEP)
    stream = re.sub(r"score_stage\w*<[^>]*>\([^;]*\);", "", no_select)
    return {"full": src, "no_select": no_select, "stream": stream}


def build(srcs: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs, libs = find_nvcc(), [], {}
    for name, text in srcs.items():
        cu, so = OUT / f"scan_{name}.cu", OUT / f"scan_{name}.so"
        cu.write_text(text)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
        libs[name] = so
    for p in procs:
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed:\n{out}")
    loaded = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        lib.wt_topk_threshold.argtypes = SIGNATURES["wt_topk_threshold"]
        lib.wt_topk_threshold.restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_threshold_scan: needs a CUDA card", file=sys.stderr)
        return 2
    libs = build(variants())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(7)
    db32 = torch.randn(N, D, generator=g, device="cuda")
    db32 /= db32.norm(dim=1, keepdim=True)
    qs = torch.randn(16, D, generator=g, device="cuda")
    qs /= qs.norm(dim=1, keepdim=True)
    stream = torch.cuda.current_stream().cuda_stream
    for db in (db32, db32.bfloat16()):
        bytes_ms = 1e3 * db.numel() * db.element_size() / 3.35e12
        for qn, k in SHAPES:
            q = qs[:qn].contiguous()
            ranges, qt, p = FT.scan_plan(N, qn, k, sms)
            out_s = torch.empty((ranges, qn, k), device="cuda")
            out_r = torch.empty((ranges, qn, k), dtype=torch.int32,
                                device="cuda")
            top_s = torch.empty((qn, k), device="cuda")
            top_r = torch.empty((qn, k), dtype=torch.int64, device="cuda")
            tickets = torch.empty(-(-qn // qt), dtype=torch.int32,
                                  device="cuda")
            want = FT.fused_topk_threshold_plain(q, db, N, k)
            ms = {}
            runs = [(name, lib, p) for name, lib in libs.items()]
            runs.insert(1, ("lists256", libs["full"], max(p, 256)))
            for name, lib, lp in runs:
                merge = name in ("full", "lists256")

                def call():
                    err = lib.wt_topk_threshold(
                        q.data_ptr(), db.data_ptr(),
                        int(db.dtype == torch.bfloat16), out_s.data_ptr(),
                        out_r.data_ptr(),
                        top_s.data_ptr() if merge else None,
                        top_r.data_ptr() if merge else None,
                        tickets.data_ptr() if merge else None, qn, D, N, N,
                        k, ranges, qt, lp, None, stream)
                    if err:
                        raise SystemExit(f"{name}: cudaError {err}")

                call()
                if merge:
                    check = FT.topk_agreement((top_s, top_r), want, tol=2e-6)
                    if not check["ok"]:
                        raise SystemExit(f"{name} off plain: {check}")
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call()
                end.record()
                torch.cuda.synchronize()
                ms[name] = start.elapsed_time(end) / 10
            print("[scan] " + " ".join(
                [f"dtype={str(db.dtype).split('.')[1]}", f"q={qn}", f"k={k}",
                 f"bound_ms={bytes_ms:.4f}"]
                + [f"{n}_ms={v:.4f}" for n, v in ms.items()]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
