"""Time the port's GEMM (wise_tpu_torch/csrc/common.cuh ``launch_gemm``) under
each tile shape and ring setting, at the main paths' products and with the
epilogue each of them runs there, beside ``torch.addmm`` on the same product,
on one CUDA GPU.

A setting is ``blocks:max_stages``: the blocks an SM holds at tiles up to
128 x 128 (``kGemmBlocksPerSM``) and the cap on the ring's stages
(``kGemmMaxStages``). For each, the script copies the kernel headers into
``build/gemm_bench/b<blocks>s<max_stages>/`` with those constants replaced,
compiles a small harness that calls ``launch_gemm`` at a given tile (BM x
BN: 128 x 256, 128 x 128, 64 x 64) with nvcc for sm_90a, and
times every (product, tile) pair with CUDA events (20 calls after 3),
checking the output against a plain f32 computation. The products, as the
ViT-H/14 block kernels run them at 256 x 257 rows: qkv (bias, bf16 out), fc
(bias + GELU, bf16 out), proj (bias + f32 residual, f32 out); and the XLM-R
text embed's qkv and proj at M = 512. Prints the card's name and power limit,
then one JSON line per (setting, product, tile).

    python3 scripts/bench_gemm_tiles.py [blocks:max_stages ...]  # 2:8 1:8

Imports torch and the port's build helpers only.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from wise_tpu_torch.ops.build import NVCC_FLAGS, find_nvcc  # noqa: E402

#: name -> (M, K, N, epilogue: 0 bias, 1 bias + GELU, 2 bias + f32 residual)
PRODUCTS = {"vit_h-qkv": (256 * 257, 1280, 3840, 0),
            "vit_h-fc": (256 * 257, 1280, 5120, 1),
            "vit_h-proj": (256 * 257, 5120, 1280, 2),
            "xlmr-qkv": (512, 1024, 3072, 0),
            "xlmr-proj": (512, 4096, 1024, 2)}
#: tile index of the harness -> (consumer warpgroups, BN)
TILES = {0: (2, 256), 1: (2, 128), 2: (1, 64)}

HARNESS = r"""
#include "common.cuh"
template <int WG, int BN>
int run(int epi, const bf16* A, const bf16* W, const bf16* bias, void* out,
        const float* res, int M, int N, int K, cudaStream_t st) {
  if (epi == 2)
    return (int)launch_gemm<float, kBiasResidual, float, WG, BN>(
        A, K, W, N, bias, (float*)out, N, res, N, kNoMap, M, N, K, kNone, st,
        nullptr);
  if (epi == 1)
    return (int)launch_gemm<bf16, kBiasAct, bf16, WG, BN>(
        A, K, W, N, bias, (bf16*)out, N, nullptr, 0, kNoMap, M, N, K, kGelu,
        st, nullptr);
  return (int)launch_gemm<bf16, kBias, bf16, WG, BN>(
      A, K, W, N, bias, (bf16*)out, N, nullptr, 0, kNoMap, M, N, K, kNone, st,
      nullptr);
}
extern "C" int bench_gemm(int tile, int epi, const bf16* A, const bf16* W,
                          const bf16* bias, void* out, const float* res,
                          int M, int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return run<2, 256>(epi, A, W, bias, out, res, M, N, K, st);
    case 1: return run<2, 128>(epi, A, W, bias, out, res, M, N, K, st);
    case 2: return run<1, 64>(epi, A, W, bias, out, res, M, N, K, st);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def build(blocks: int, max_stages: int) -> ctypes.CDLL:
    """The harness against common.cuh with the ring's constants set."""
    out = ROOT / "build" / "gemm_bench" / f"b{blocks}s{max_stages}"
    out.mkdir(parents=True, exist_ok=True)
    for src in (ROOT / "wise_tpu_torch" / "csrc").glob("*.cuh"):
        text = re.sub(r"constexpr int kGemmMaxStages = \d+;",
                      f"constexpr int kGemmMaxStages = {max_stages};",
                      src.read_text())
        text = re.sub(r"constexpr int kGemmBlocksPerSM = \d+;",
                      f"constexpr int kGemmBlocksPerSM = {blocks};", text)
        (out / src.name).write_text(text)
    (out / "harness.cu").write_text(HARNESS)
    so = out / "harness.so"
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(so),
                    str(out / "harness.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.bench_gemm.argtypes = [ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.bench_gemm.restype = ctypes.c_int
    return lib


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(settings) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm_tiles: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    gelu = torch.nn.functional.gelu
    for setting in settings:
        lib = build(*map(int, setting.split(":")))
        for name, (m, k, n, epi) in PRODUCTS.items():
            a = torch.randn(m, k, generator=g, device="cuda").to(bf)
            w = (torch.randn(k, n, generator=g, device="cuda")
                 * k ** -0.5).to(bf)
            bias = (0.02 * torch.randn(n, generator=g, device="cuda")).to(bf)
            res = torch.randn(m, n, generator=g, device="cuda")
            want = torch.addmm(bias.float(), a.float(), w.float())
            want = (gelu(want) if epi == 1 else
                    res + want if epi == 2 else want)
            addmm_ms = cuda_ms(lambda: torch.addmm(bias, a, w))
            out = torch.empty(m, n, device="cuda",
                              dtype=torch.float32 if epi == 2 else bf)
            stream = torch.cuda.current_stream().cuda_stream
            for tile, (wg, bn) in TILES.items():
                def call():
                    return lib.bench_gemm(
                        tile, epi, a.data_ptr(), w.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), res.data_ptr(), m,
                        n, k, stream)

                err = call()
                torch.cuda.synchronize()
                row = dict(setting=setting, product=name,
                           tile=f"{64 * wg}x{bn}")
                if err:
                    print(json.dumps(dict(row, error=err)), flush=True)
                    continue
                ms = cuda_ms(call)
                print(json.dumps(dict(
                    row, ms=round(ms, 4), addmm_ms=round(addmm_ms, 4),
                    tflops=round(2 * m * k * n / ms / 1e9, 1),
                    max_abs_err=float((out.float() - want).abs().max()))),
                    flush=True)
            del a, w, res, want, out
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:] or ["2:8", "1:8"])
