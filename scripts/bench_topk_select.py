#!/usr/bin/env python3
"""Time fused_topk's selection kernel (wise_tpu_torch/csrc/topk_kernels.cu
``topk_select_kernel``) on one CUDA card, apart and cut after each phase.

    python3 scripts/bench_topk_select.py

On an Sᵀ of 1,048,576 rows x 64 queries (seeded unit vectors, scored by the
f32 product kernel), it prints ``[select]`` lines: the kernel's ms at groups
of 4096 and 1024 rows and k = 1, 10, 100, 300, 1000, with the overflow
branch's count; ``[phase]`` lines: at groups of 4096 and k = 1 and 100, a
copy of the kernel cut after each phase (0: Sᵀ loaded and stored as keys;
1: + the lower bound τ; 2: + the survivors appended; 3: + the final sort and
the write-out, the whole kernel), compiled from the source with nvcc into
build/bench/; and a ``[merge]`` line: the keyed merge and its parts. CUDA
events, 10 calls after 3. Needs nvcc and one card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from wise_tpu_torch.ops import fused_topk as FT  # noqa: E402
from wise_tpu_torch.ops.build import NVCC_FLAGS, find_nvcc  # noqa: E402

CSRC = ROOT / "wise_tpu_torch" / "csrc"
OUT = ROOT / "build" / "bench"


def phase_source() -> str:
    """The selection section of topk_kernels.cu, templated on the phase it
    stops after, with a C entry that launches it."""
    src = (CSRC / "topk_kernels.cu").read_text()
    a = src.index("// The group selection of both storage types: Sᵀ -> each "
                  "group's top-k")
    a = src.rfind("// -----", 0, a)
    sel = src[a:src.index("}  // namespace")]
    cuts = [
        ("__device__ __forceinline__ int select_segment(",
         "template <int PH>\n__device__ __forceinline__ int select_segment("),
        ("  tau = max(tau, max(t, 1u));\n",
         "  tau = max(tau, max(t, 1u));\n  if (PH == 1) return c;\n"),
        ("  int n = append_survivors(keys, n32, row_base, buf, c, cap, tau, "
         "lane);\n",
         "  int n = append_survivors(keys, n32, row_base, buf, c, cap, tau, "
         "lane);\n  if (PH == 2) return min(c + n, cap);\n"),
        ("__global__ void __launch_bounds__(kSelThreads, 2)\n"
         "topk_select_kernel(",
         "template <int PH>\n__global__ void __launch_bounds__(kSelThreads, "
         "2)\nphase_kernel("),
        ("    if (selects)\n      c = select_segment(",
         "    if (PH == 0 && selects)\n"
         "      c += (int)(keys[warp * kSegStride + lane] & 1u);\n"
         "    if (PH > 0 && selects)\n      c = select_segment<PH>("),
        ("  if (!selects) return;\n  c = keep_at_least(",
         "  if (!selects) return;\n  if (PH == 3) c = keep_at_least("),
        ("  sort_desc(buf, p, lane);\n  c = min(k, c);",
         "  if (PH == 3) sort_desc(buf, p, lane);\n  c = min(k, c);"),
    ]
    for old, new in cuts:
        if sel.count(old) != 1:
            raise SystemExit(f"the kernel no longer has: {old!r}")
        sel = sel.replace(old, new)
    return ('#include "common.cuh"\nnamespace {\n' + sel + "}  // namespace\n"
            + r'''
extern "C" int phase_select(int ph, const float* st, int ld, int rows,
                            int n_valid, int k, int group, int qc,
                            float* out_s, int* out_r, int Q, void* stream) {
  int cap = 512;
  while (cap < 2 * k) cap <<= 1;
  const size_t smem = (size_t)kSelQ * kSegStride * 4 + (size_t)kSelQ * cap * 8;
  const dim3 grid((qc + kSelQ - 1) / kSelQ, rows / group);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GO(P)                                                               \
  do {                                                                      \
    cudaFuncSetAttribute(phase_kernel<P>,                                   \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,       \
                         (int)smem);                                        \
    phase_kernel<P><<<grid, kSelThreads, smem, s>>>(                        \
        st, ld, 0, n_valid, k, group, qc, cap, out_s, out_r, Q, 0, nullptr); \
  } while (0)
  if (ph == 0) GO(0); else if (ph == 1) GO(1); else if (ph == 2) GO(2);
  else GO(3);
  return (int)cudaGetLastError();
}
''')


def ms(fn, iters: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "select_phases.cu", OUT / "select_phases.so"
    cu.write_text(phase_source())
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(CSRC),
                    "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.phase_select.argtypes = [I, P, I, I, I, I, I, I, P, P, I, P]

    g = torch.Generator(device="cuda").manual_seed(1234)
    n, d, qn = 1 << 20, 512, 64
    db = torch.randn(n, d, generator=g, device="cuda")
    db /= db.norm(dim=1, keepdim=True)
    q = torch.randn(qn, d, generator=g, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    st = torch.empty((n, qn), device="cuda")
    FT.scores_t_f32_cuda(db, q, st)
    del db
    stream = torch.cuda.current_stream().cuda_stream

    def outs(group, k):
        s = torch.empty((n // group, qn, k), device="cuda")
        return s, torch.empty(s.shape, dtype=torch.int32, device="cuda")

    for group in (4096, 1024):
        for k in (1, 10, 100, 300, 1000):
            out_s, out_r = outs(group, k)

            def call():
                FT.select_groups_cuda(st, 0, n, k, group, out_s, out_r, 0,
                                      qn)
            FT.reset_overflows("cuda")
            call()
            over = FT.overflow_count("cuda")
            print(f"[select] group={group} k={k} ms={ms(call):.4f} "
                  f"overflows={over}", flush=True)
    for k in (1, 100):
        out_s, out_r = outs(4096, k)
        for ph in range(4):
            t = ms(lambda: lib.phase_select(
                ph, st.data_ptr(), qn, n, n, k, 4096, qn, out_s.data_ptr(),
                out_r.data_ptr(), qn, stream))
            print(f"[phase] group=4096 k={k} phase={ph} ms={t:.4f}",
                  flush=True)
    k = 100
    out_s, out_r = outs(4096, k)
    FT.select_groups_cuda(st, 0, n, k, 4096, out_s, out_r, 0, qn)
    s = out_s.permute(1, 0, 2).reshape(qn, -1)
    r = out_r.permute(1, 0, 2).reshape(qn, -1)
    key = FT.order_key(s, r)
    print(f"[merge] k={k} ms={ms(lambda: FT._merge(out_s, out_r, k)):.4f} "
          f"key_ms={ms(lambda: FT.order_key(s, r)):.4f} "
          f"topk_int64_ms={ms(lambda: torch.topk(key, k, dim=1)):.4f} "
          f"st_clone_ms={ms(lambda: st.clone()):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
