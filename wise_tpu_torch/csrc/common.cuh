#pragma once

// Shared building blocks of the port's CUDA kernels (sm_90a): LayerNorm,
// the bf16 GEMM (TMA loads, wgmma tiles) with its fused epilogues, and
// their launch helpers. block_kernels.cu (the CLIP towers), postln_kernels.cu
// (the XLM-R text tower) and swin_kernels.cu (CLAP's HTSAT) chain them with
// their attention kernels (attention.cuh; the Swin window attention is
// swin_kernels.cu's own).
//
// Everything here has internal linkage (an anonymous namespace), so each
// translation unit that includes the header holds its own copy.

#include <cuda.h>  // CUtensorMap and its enums (no driver library linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kEps = 1e-5f;

// kBiasActPre is kBiasAct that also stores the pre-activation value
// (acc + bias, rounded to the output type) to a second output: the residual
// the training backward differentiates the activation at.
enum Epilogue { kBias = 0, kBiasAct = 1, kBiasResidual = 2, kBiasActPre = 3 };
enum Act { kNone = 0, kGelu = 1, kQuickGelu = 2, kGeluTanh = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float activation(float v, int act) {
  switch (act) {
    case kGelu:
      return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    case kQuickGelu:
      return v / (1.f + expf(-1.702f * v));
    case kGeluTanh:
      return 0.5f * v *
             (1.f + tanhf(0.79788456080286536f * (v + 0.044715f * v * v * v)));
    default:
      return v;
  }
}

// The pooled row of example b: rows[b] (clamped into [0, sp), so a bad
// index cannot read outside the example) or the static row0.
__device__ __forceinline__ int pooled_row(const int* rows, int row0, int b,
                                          int sp) {
  return rows ? min(max(rows[b], 0), sp - 1) : row0;
}

// A row of a GEMM operand, optionally mapped. kGatherPooled: row m of the
// logical matrix lies at row m * sp + pooled_row(m) of the stored one (the
// pooled blocks read one token per example out of the (B * SP, D) stream).
// kRowInExample: row m lies at row m mod sp (the embed fold reads its
// (SP, D) positional table under the (B * SP, D) patch product).
enum RowMode { kRowsAsIs = 0, kGatherPooled = 1, kRowInExample = 2 };

struct RowMap {
  const int* rows;
  int row0;
  int sp;
  int gather;
};

__device__ __forceinline__ size_t map_row(const RowMap& g, int m) {
  if (g.gather == kRowInExample) return (size_t)(m % g.sp);
  if (g.gather != kGatherPooled) return (size_t)m;
  return (size_t)m * g.sp + pooled_row(g.rows, g.row0, m, g.sp);
}

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row, f32 statistics, bf16 output (the GEMM
// operand) unless TY says otherwise (the embed fold's ln_pre writes the f32
// residual stream)
// ---------------------------------------------------------------------------

template <typename T, typename TY = bf16>
__global__ void __launch_bounds__(256)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, TY* __restrict__ y, int M,
                 int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  float sum = 0.f, sq = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = to_f(xr[i]);
    sum += v;
    sq += v * v;
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mean = sum / D;
  const float var = fmaxf(sq / D - mean * mean, 0.f);
  const float rs = rsqrtf(var + kEps);
  TY* yr = y + (size_t)row * D;
  for (int i = lane; i < D; i += 32)
    yr[i] = from_f<TY>((to_f(xr[i]) - mean) * (rs * scale[i]) + bias[i]);
}

// ---------------------------------------------------------------------------
// cp.async: the attention kernels' 16-byte copies global -> shared
// ---------------------------------------------------------------------------

// 16-byte asynchronous copy global -> shared; !pred writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// GEMM: out[m, n] = epilogue(sum_k A[m, k] W[k, n] + bias[n])
//
// Replaces the matrix products inside the Pallas block kernels
// (wise_tpu/ops/block.py _fc_kernel, _proj_kernel and the blocks' own dots):
// every GEMM of the port runs here. A (M, K) bf16 row-major with row stride
// lda, W (K, N) bf16 row-major with row stride ldw, f32 accumulation.
//
// What bounds it: at the towers' batch sizes the products are
// compute-bound (ViT-H/14's 65,792 x 1280 x 3840 does ~500 operations a
// byte against the card's ~295), so the tensor cores' rate decides, and
// Hopper reaches it only through wgmma fed from shared memory. The design:
//   - tiles of BM x BN outputs (128 x 256 where N is a multiple of 256 and
//     the epilogue has no activation, else 128 x 128; 64 x 64 where a grid
//     of 128 x 128 tiles would leave over half the SMs idle, as an XLM-R
//     text embed's out-projection at M = 512 does), K in steps of
//     kGemmBK = 64 bf16: one 128-byte row, the span of TMA's 128-byte
//     swizzle;
//   - persistent blocks, two an SM (one at 128 x 256), each walking its
//     share of the tiles: a tile's epilogue runs while the next tile's first
//     stages load, and beside the other block's products;
//   - one producer warp issues the TMA loads of each stage (A as one box of
//     BM rows x 64, W as BN / 64 boxes of 64 rows x 64 columns) into a ring
//     of as many stages as the block's share of shared memory holds (4 at
//     128 x 256, 3 at 128 x 128, up to kGemmMaxStages), each with a full
//     barrier (TMA's transaction bytes complete it) and an empty barrier
//     (every consumer warp arrives when its wgmma has read the stage);
//   - BM / 64 consumer warpgroups, each owning 64 rows of the tile, run
//     wgmma.mma_async m64nBNk16 on shared-memory descriptors, A K-major and
//     W MN-major (the transpose-B immediate: the weights stay (K, N) as the
//     wrappers pass them), one commit group per stage with one group left in
//     flight while the next stage's group is issued;
//   - the epilogue works from the accumulator registers (the m64nNk16 D
//     fragment: register 4j + 2h + e of thread t holds row
//     16 (t / 32) + (t % 32) / 4 + 8h, column 8j + 2 (t % 4) + e) and stores
//     column pairs.
// The tensor maps cover the logical operand (M x K of A, K x N of W at
// stride ldw), so TMA fills zeros past the M, N and K edges: a ragged tile
// needs no masking in the mainloop, and a W slice of a wider matrix (the
// pooled block's k/v columns of wqkv) reads none of its neighbours. TMA
// takes 16-byte-aligned base addresses and row strides; a call that does
// not meet that, or an odd N, returns cudaErrorInvalidValue.
//
// Rounding: the epilogue's arithmetic is the one every block kernel has
// always had (v = acc + bias in f32; pre = TO(v); v = act(v); with a
// residual, out = TO(r + to_f(TO(v))), else out = TO(v)); only the order of
// the sum over K is the tensor cores'.
//
// The layout constants below (kGemm*, kSwz*, kDesc*) are the ones
// tests/test_torch_gemm_layout.py reads and rehearses in numpy: TMA's
// 128-byte swizzle, the addresses the descriptors read back, the D fragment.
// ---------------------------------------------------------------------------

constexpr int kGemmBK = 64;          // K per stage (bf16): one 128-byte row
constexpr int kGemmMaxStages = 8;    // the ring: as many stages as fit, to 8
constexpr int kGemmBlocksPerSM = 2;  // blocks an SM holds, to 128 x 128
constexpr int kSmemPerSM = 233472;   // 228 KB an SM, 1 KB of it kept per block
constexpr int kWgRows = 64;          // rows of A a consumer warpgroup owns
constexpr int kGemmBM = 2 * kWgRows; // rows of the full tile
constexpr int kWgmmaK = 16;          // K of one wgmma
constexpr int kBoxCols = 64;         // W columns in one TMA box (128 bytes)
constexpr int kSwzRowBytes = 128;    // bytes of a swizzled row
constexpr int kSwzAtomBytes = 1024;  // 8 rows: the span the XOR repeats over
// descriptor strides in bytes (the encoding drops the low 4 bits).
// A, K-major: the next 8 rows of M lie one atom on; LBO is not read.
constexpr int kDescSboA = kSwzAtomBytes;
constexpr int kDescLboA = 16;
// W, MN-major: the next 8 rows of K lie one atom on (SBO); the next 64
// columns of N in the next box (LBO).
constexpr int kDescSboW = kSwzAtomBytes;
constexpr int kDescLboW = kGemmBK * kBoxCols * 2;
// the wgmma descriptor's layout type of a 128-byte swizzle (bits 62-63)
constexpr uint64_t kDescSwizzle128 = 1ull << 62;

template <int WG, int BN>
struct GemmTile {
  static constexpr int BM = WG * kWgRows;
  static constexpr int kABytes = BM * kGemmBK * 2;
  static constexpr int kWBytes = kGemmBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kWBytes;
  // two blocks an SM, so that one's epilogue runs beside the other's
  // products, except the 128 x 256 tile, whose accumulators take half the
  // registers
  static constexpr int kBlocks = BN > 128 ? 1 : kGemmBlocksPerSM;
  static constexpr int kBudget = kSmemPerSM / kBlocks - 1024;
  // as many stages (each with its two barriers) as fit beside room to align
  // the ring to the atom
  static constexpr int kFit = (kBudget - kSwzAtomBytes) / (kStageBytes + 16);
  static constexpr int kStages = kFit < kGemmMaxStages ? kFit : kGemmMaxStages;
  static constexpr int kThreads = WG * 128 + 32;  // consumers + producer warp
  static constexpr size_t kSmem =
      (size_t)kStages * (kStageBytes + 16) + kSwzAtomBytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one 2-D box of a tensor map (c0 the inner coordinate) into shared memory,
// completing ``bytes`` of the barrier's transaction count
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// a wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units, 14 bits each), 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | kDescSwizzle128;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to the accumulators across the
// asynchronous wgmma that owns them
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D += A W on one k16 slice: A K-major, W MN-major (transpose-B 1), bf16 in,
// f32 accumulators, scale-d 1
template <int BN>
struct Wgmma;

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t dw) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(dw), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t dw) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(dw), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t dw) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87,"
        "%88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103,"
        "%104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(dw), "r"(1));
  }
};

// D += A B on one k8 slice of TF32: A (m64 x k8) from registers, four
// 32-bit values a thread (the fragment of mma.m16n8k8's tf32 A, warp w of the
// warpgroup holding rows 16w .. 16w + 15: a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4) with g = lane / 4, t = lane % 4), B (k8 x n64)
// K-major from shared memory under its descriptor (tf32 takes no transpose),
// f32 accumulators as the bf16 forms' D fragment; scale_d 0 starts D at A B.
// The tensor cores read 19 bits of each 32-bit value: the operands come
// rounded (tf32_rna).
struct WgmmaTf32 {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as a 32-bit value whose low 13 bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// keeps the compiler from reusing the registers of an A fragment that an
// asynchronous wgmma may still read (the counterpart of fence_acc)
template <int R>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The epilogue of one warpgroup's 64 x BN accumulators (the D fragment:
// register 4j + 2h + e holds row ``row`` + 8h, column ``col`` + 8j + e),
// column pairs at a time. The residual is read as TR (the pre-LN blocks add
// in the stream's type, TR = TO; the post-LN blocks add a bf16 x into an f32
// sum, TO = float). ``pre`` (kBiasActPre only) has out's shape and row
// stride: both values come from one accumulator, so the second output costs
// its bytes and no pass. ACT is the activation, fixed per call so that the
// unrolled loop carries no branch on it.
template <typename TO, int EPI, typename TR, int BN, int ACT>
__device__ __forceinline__ void store_tile(
    const float (&acc)[BN / 2], int row, int col, int M, int N,
    const bf16* __restrict__ bias, TO* __restrict__ out, int ldo,
    const TR* __restrict__ res, int ldr, const RowMap& rmap,
    TO* __restrict__ pre) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row + 8 * h;
    if (m >= M) continue;
    TO* out_m = out + (size_t)m * ldo;
    const TR* res_m = EPI == kBiasResidual ? res + map_row(rmap, m) * ldr
                                           : nullptr;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = col + 8 * j;
      if (n >= N) continue;  // N is even: n < N holds n + 1 < N
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (bias) {
        v0 += __bfloat162float(bias[n]);
        v1 += __bfloat162float(bias[n + 1]);
      }
      if (EPI == kBiasActPre) store2<TO>(pre + (size_t)m * ldo + n, v0, v1);
      if (EPI == kBiasAct || EPI == kBiasActPre) {
        v0 = activation(v0, ACT);
        v1 = activation(v1, ACT);
      }
      if (EPI == kBiasResidual) {
        const float2 r = load2(res_m + n);
        v0 = r.x + to_f(from_f<TO>(v0));
        v1 = r.y + to_f(from_f<TO>(v1));
      }
      store2<TO>(out_m + n, v0, v1);
    }
  }
}

// A persistent block walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// (N fastest); threads [0, 128 WG) are the consumer warpgroups, the last
// warp the producer. The ring's stage and phase run on across tiles, so the
// producer loads the next tile's first stages while the consumers store the
// last one's outputs.
template <typename TO, int EPI, typename TR, int WG, int BN>
__global__ void __launch_bounds__(GemmTile<WG, BN>::kThreads,
                                  GemmTile<WG, BN>::kBlocks)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
            const __grid_constant__ CUtensorMap tma_w,
            const bf16* __restrict__ bias, TO* __restrict__ out, int ldo,
            const TR* __restrict__ res, int ldr, RowMap rmap, int M, int N,
            int K, int act, TO* __restrict__ pre) {
  using T = GemmTile<WG, BN>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char gemm_smem[];
  // the ring starts on a swizzle atom: TMA and wgmma swizzle by address
  const uint32_t ring = (smem_addr(gemm_smem) + kSwzAtomBytes - 1) &
                        ~(uint32_t)(kSwzAtomBytes - 1);
  const uint32_t full = ring + S * T::kStageBytes;
  const uint32_t empty = full + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + T::BM - 1) / T::BM * tiles_n;
  const int KT = (K + kGemmBK - 1) / kGemmBK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WG) {  // producer
    if (lane == 0) {
      int it = 0;  // k-steps this block has loaded
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * T::BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % S;
          // the stage's previous use (k-step it - S) is released
          if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);
          const uint32_t a_s = ring + s * T::kStageBytes;
          const uint32_t w_s = a_s + T::kABytes;
          mbar_expect_tx(full + 8 * s, T::kStageBytes);
          tma_load_2d(a_s, &tma_a, kt * kGemmBK, m0, full + 8 * s);
#pragma unroll
          for (int j = 0; j < BN / kBoxCols; ++j)
            tma_load_2d(w_s + j * kGemmBK * kSwzRowBytes, &tma_w,
                        n0 + j * kBoxCols, kt * kGemmBK, full + 8 * s);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[BN / 2];
  int it = 0;  // k-steps this warpgroup has consumed
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * T::BM, n0 = tile % tiles_n * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(full + 8 * s, (it / S) & 1);
      const uint32_t stage = ring + s * T::kStageBytes;
      const uint32_t a_s = stage + wg * kWgRows * kSwzRowBytes;
      const uint32_t w_s = stage + T::kABytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / kWgmmaK; ++kk)
        Wgmma<BN>::mma(
            acc, smem_desc(a_s + kk * kWgmmaK * 2, kDescLboA, kDescSboA),
            smem_desc(w_s + kk * kWgmmaK * kSwzRowBytes, kDescLboW,
                      kDescSboW));
      wgmma_commit();
      fence_acc(acc);
      // k-step it - 1's group is done: its stage goes back to the producer
      wgmma_wait<1>();
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));

    const int row = m0 + wg * kWgRows + (warp & 3) * 16 + (lane >> 2);
    const int col = n0 + (lane & 3) * 2;
    const int f = EPI == kBiasAct || EPI == kBiasActPre ? act : kNone;
    if (f == kGelu)
      store_tile<TO, EPI, TR, BN, kGelu>(acc, row, col, M, N, bias, out, ldo,
                                         res, ldr, rmap, pre);
    else if (f == kQuickGelu)
      store_tile<TO, EPI, TR, BN, kQuickGelu>(acc, row, col, M, N, bias, out,
                                              ldo, res, ldr, rmap, pre);
    else if (f == kGeluTanh)
      store_tile<TO, EPI, TR, BN, kGeluTanh>(acc, row, col, M, N, bias, out,
                                             ldo, res, ldr, rmap, pre);
    else
      store_tile<TO, EPI, TR, BN, kNone>(acc, row, col, M, N, bias, out, ldo,
                                         res, ldr, rmap, pre);
  }
}

// ---------------------------------------------------------------------------
// host-side launch helpers
// ---------------------------------------------------------------------------

const RowMap kNoMap = {nullptr, 0, 0, kRowsAsIs};

template <typename T, typename TY = bf16>
cudaError_t launch_layernorm(const void* x, const float* s, const float* b,
                             TY* y, int M, int D, cudaStream_t st) {
  layernorm_kernel<T, TY><<<(M + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(x), s, b, y, M, D);
  return cudaGetLastError();
}

cudaError_t layernorm(const void* x, int x_f32, const float* s, const float* b,
                      bf16* y, int M, int D, cudaStream_t st) {
  return x_f32 ? launch_layernorm<float>(x, s, b, y, M, D, st)
               : launch_layernorm<bf16>(x, s, b, y, M, D, st);
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// that the library links against the runtime alone
typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The matrix of rows x cols elements of T (bf16 or f32) at row stride ld
// (elements) as a TMA map of box_rows x box_cols boxes under the 128-byte
// swizzle (box_cols * sizeof(T) = 128 bytes); zeros past its edges
template <typename T>
cudaError_t tile_map(CUtensorMap* map, const T* p, int rows, int cols, int ld,
                     int box_rows, int box_cols) {
  if (!aligned(p, 16) || (ld * sizeof(T)) % 16 != 0 || ld < cols)
    return cudaErrorInvalidValue;
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<T*>(p), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Devices a PerDevice flag set tracks; a device past them sets its
// attribute at every launch.
constexpr int kMaxDevices = 64;

// Whether a launch site has set its kernel's attribute on each device: a
// static of the site (one a kernel). The attribute belongs to the current
// device's context, so a process that launches on several cards (a sharded
// search) sets it on each.
struct PerDevice {
  std::atomic<bool> done[kMaxDevices];
};

// The kernel's dynamic shared-memory cap, set once a device through the
// site's own ``once``.
template <typename F>
cudaError_t max_dynamic_smem(PerDevice& once, F* kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool tracked = dev >= 0 && dev < kMaxDevices;
  if (tracked && once.done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && tracked)
    once.done[dev].store(true, std::memory_order_release);
  return err;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

// names T without letting a call deduce it: the residual's type comes from the
// template arguments alone, and a pointer of another type does not compile
template <typename T>
struct as_given {
  using type = T;
};

// tiles of bm x bn over an M x N output
long long gemm_tiles(int M, int N, int bm, int bn) {
  return (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

template <typename TO, int EPI, typename TR, int WG, int BN>
cudaError_t launch_gemm(const bf16* A, int lda, const bf16* W, int ldw,
                        const bf16* bias, TO* out, int ldo, const TR* res,
                        int ldr, RowMap rmap, int M, int N, int K, int act,
                        cudaStream_t st, TO* pre) {
  using T = GemmTile<WG, BN>;
  const long long tiles = gemm_tiles(M, N, T::BM, BN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const long long slots = (long long)T::kBlocks * sm_count();
  const int grid = (int)(tiles < slots ? tiles : slots);
  CUtensorMap map_a, map_w;
  cudaError_t err = tile_map<bf16>(&map_a, A, M, K, lda, T::BM, kGemmBK);
  if (err != cudaSuccess) return err;
  err = tile_map<bf16>(&map_w, W, K, N, ldw, kGemmBK, kBoxCols);
  if (err != cudaSuccess) return err;
  static PerDevice smem_set;
  err = max_dynamic_smem(smem_set, gemm_kernel<TO, EPI, TR, WG, BN>,
                         (int)T::kSmem);
  if (err != cudaSuccess) return err;
  gemm_kernel<TO, EPI, TR, WG, BN><<<grid, T::kThreads, T::kSmem, st>>>(
      map_a, map_w, bias, out, ldo, res, ldr, rmap, M, N, K, act, pre);
  return cudaGetLastError();
}

// ``res`` points at TR values (null where EPI adds no residual); ``pre`` is
// kBiasActPre's second output (null otherwise). The tile: 128 x 256 where N
// is a multiple of 256, the epilogue applies no activation (one block an SM
// leaves an activation's epilogue beside no products: 128 x 128 runs it
// faster) and the grid fills a wave of SMs; else 128 x 128, unless that grid
// would leave over half the SMs idle: then 64 x 64.
template <typename TO, int EPI, typename TR = TO>
cudaError_t gemm(const bf16* A, int lda, const bf16* W, int ldw,
                 const bf16* bias, TO* out, int ldo,
                 const typename as_given<TR>::type* res, int ldr, RowMap rmap,
                 int M, int N, int K, int act, cudaStream_t st,
                 TO* pre = nullptr) {
  // the epilogue stores (and reads the residual in) column pairs
  const size_t pair = 2 * sizeof(TO);
  if (M < 1 || N < 1 || K < 1 || N % 2 != 0 || ldo % 2 != 0 ||
      !aligned(out, pair) || (pre && !aligned(pre, pair)) ||
      (EPI == kBiasActPre && !pre) ||
      (EPI == kBiasResidual &&
       (!res || ldr % 2 != 0 || !aligned(res, 2 * sizeof(TR)))))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  const bool activates = (EPI == kBiasAct || EPI == kBiasActPre) && act;
  if (!activates && N % 256 == 0 && gemm_tiles(M, N, kGemmBM, 256) >= sms)
    return launch_gemm<TO, EPI, TR, 2, 256>(A, lda, W, ldw, bias, out, ldo,
                                            res, ldr, rmap, M, N, K, act, st,
                                            pre);
  if (2 * gemm_tiles(M, N, kGemmBM, 128) >= sms)
    return launch_gemm<TO, EPI, TR, 2, 128>(A, lda, W, ldw, bias, out, ldo,
                                            res, ldr, rmap, M, N, K, act, st,
                                            pre);
  return launch_gemm<TO, EPI, TR, 1, 64>(A, lda, W, ldw, bias, out, ldo, res,
                                         ldr, rmap, M, N, K, act, st, pre);
}

// out = res + (A W + bias) in x's dtype (out and res both float or both bf16)
cudaError_t gemm_residual(const bf16* A, int lda, const bf16* W, int ldw,
                          const bf16* bias, void* out, int ldo,
                          const void* res, int ldr, RowMap rmap, int x_f32,
                          int M, int N, int K, cudaStream_t st) {
  if (x_f32)
    return gemm<float, kBiasResidual>(
        A, lda, W, ldw, bias, static_cast<float*>(out), ldo,
        static_cast<const float*>(res), ldr, rmap, M, N, K, kNone, st);
  return gemm<bf16, kBiasResidual>(
      A, lda, W, ldw, bias, static_cast<bf16*>(out), ldo,
      static_cast<const bf16*>(res), ldr, rmap, M, N, K, kNone, st);
}

#define WT_CHECK(expr)                \
  do {                                \
    cudaError_t err_ = (expr);        \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace
