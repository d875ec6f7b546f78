#pragma once

// Shared building blocks of the port's CUDA kernels (sm_90a): LayerNorm,
// the bf16 WMMA GEMM with its fused epilogues, and their launch helpers.
// block_kernels.cu (the CLIP towers), postln_kernels.cu (the XLM-R text
// tower) and swin_kernels.cu (CLAP's HTSAT) chain them with their attention
// kernels (attention.cuh; the Swin window attention is swin_kernels.cu's own).
//
// Everything here has internal linkage (an anonymous namespace), so each
// translation unit that includes the header holds its own copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
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
// GEMM: out[m, n] = epilogue(sum_k A[m, k] W[k, n] + bias[n])
// A (M, K) bf16 row-major (rows through an optional RowMap), W (K, N) bf16
// row-major. 128x128 block tile, BK = 32, a 4-stage cp.async pipeline in
// dynamic shared memory, 8 warps each holding a 64x32 tile as 4x2 WMMA
// accumulators. K % 32 == 0, N % 8 == 0; rows m >= M load as zeros.
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, kStages = 4, kGemmThreads = 256;
constexpr int A_LD = BK + 8;   // +8 bf16 breaks the bank pattern, keeps 16B rows
constexpr int B_LD = BN + 8;
constexpr int A_STAGE = BM * A_LD, B_STAGE = BK * B_LD;  // elements
constexpr size_t kGemmSmem = (size_t)kStages * (A_STAGE + B_STAGE) * sizeof(bf16);

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

// The residual is read as TR (the pre-LN blocks add in the stream's type,
// TR = TO; the post-LN blocks add a bf16 x into an f32 sum, TO = float).
// ``pre`` (kBiasActPre only) has out's shape and row stride: both values come
// from one accumulator, so the second output costs its bytes and no pass.
template <typename TO, int EPI, typename TR>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const bf16* __restrict__ A, int lda, RowMap amap,
            const bf16* __restrict__ W, int ldw,
            const bf16* __restrict__ bias, TO* __restrict__ out, int ldo,
            const TR* __restrict__ res, int ldr, RowMap rmap, int M, int N,
            int K, int act, TO* __restrict__ pre) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);
  bf16* Bs = As + kStages * A_STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64;  // 2 warp rows x 4 warp columns
  const int wn = (warp & 3) * 32;

  // each thread copies two 16-byte chunks of A (rows tid/4 and tid/4 + 64)
  // and two of W (rows tid/16 and tid/16 + 16) per stage
  const int a_row = tid >> 2, a_col = (tid & 3) * 8;
  const int b_row = tid >> 4, b_col = (tid & 15) * 8;
  const bf16* a_src[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + a_row + i * 64;
    a_ok[i] = m < M;
    a_src[i] = a_ok[i] ? A + map_row(amap, m) * lda + a_col : A;
  }
  const bool b_ok = n0 + b_col < N;
  const bf16* b_src = W + (b_ok ? n0 + b_col : 0);

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(as + (a_row + i * 64) * A_LD + a_col,
                 a_src[i] + (a_ok[i] ? k0 : 0), a_ok[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = b_row + i * 16;
      cp_async16(bs + r * B_LD + b_col,
                 b_src + (b_ok ? (size_t)(k0 + r) * ldw : 0), b_ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // k-tile kt has landed
    __syncthreads();               // ... and every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next);
    cp_async_commit();
    const bf16* as = As + (kt % kStages) * A_STAGE;
    const bf16* bs = Bs + (kt % kStages) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], as + (wm + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], bs + kk * B_LD + wn + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline's shared memory becomes epilogue staging

  // epilogue: each warp stages one 16x16 accumulator at a time
  float* cs = reinterpret_cast<float*>(gemm_smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm + i * 16 + (e >> 4);
        const int n = n0 + wn + j * 16 + (e & 15);
        if (m < M && n < N) {
          float v = cs[e];
          if (bias) v += __bfloat162float(bias[n]);
          if (EPI == kBiasActPre) pre[(size_t)m * ldo + n] = from_f<TO>(v);
          if (EPI == kBiasAct || EPI == kBiasActPre) v = activation(v, act);
          if (EPI == kBiasResidual) {
            const float r = to_f(res[map_row(rmap, m) * ldr + n]);
            out[(size_t)m * ldo + n] = from_f<TO>(r + to_f(from_f<TO>(v)));
          } else {
            out[(size_t)m * ldo + n] = from_f<TO>(v);
          }
        }
      }
      __syncwarp();
    }
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

// names T without letting a call deduce it: the residual's type comes from the
// template arguments alone, and a pointer of another type does not compile
template <typename T>
struct as_given {
  using type = T;
};

// ``res`` points at TR values (null where EPI adds no residual); ``pre`` is
// kBiasActPre's second output (null otherwise)
template <typename TO, int EPI, typename TR = TO>
cudaError_t gemm(const bf16* A, int lda, RowMap amap, const bf16* W, int ldw,
                 const bf16* bias, TO* out, int ldo,
                 const typename as_given<TR>::type* res, int ldr, RowMap rmap,
                 int M, int N, int K, int act, cudaStream_t st,
                 TO* pre = nullptr) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<TO, EPI, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<TO, EPI, TR><<<grid, kGemmThreads, kGemmSmem, st>>>(
      A, lda, amap, W, ldw, bias, out, ldo, res, ldr, rmap, M, N, K, act,
      pre);
  return cudaGetLastError();
}

// out = res + (A W + bias) in x's dtype (out and res both float or both bf16)
cudaError_t gemm_residual(const bf16* A, int lda, RowMap amap, const bf16* W,
                          int ldw, const bf16* bias, void* out, int ldo,
                          const void* res, int ldr, RowMap rmap, int x_f32,
                          int M, int N, int K, cudaStream_t st) {
  if (x_f32)
    return gemm<float, kBiasResidual>(
        A, lda, amap, W, ldw, bias, static_cast<float*>(out), ldo,
        static_cast<const float*>(res), ldr, rmap, M, N, K, kNone, st);
  return gemm<bf16, kBiasResidual>(
      A, lda, amap, W, ldw, bias, static_cast<bf16*>(out), ldo,
      static_cast<const bf16*>(res), ldr, rmap, M, N, K, kNone, st);
}

#define WT_CHECK(expr)                \
  do {                                \
    cudaError_t err_ = (expr);        \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace
