// Transformer-block kernels for Hopper (sm_90a): the CLIP towers' residual
// blocks as short chains of hand-written kernels.
//
// Replaces the Pallas TPU kernels of wise_tpu/ops/block.py:
//   wt_attn_block         <- fused_attn_block            (_attn_block_kernel)
//   wt_mlp_block          <- fused_mlp_block             (_mlp_block_kernel)
//   wt_attn_block_pooled  <- fused_attn_block_pooled     (_attn_block_pooled_kernel)
//                            fused_attn_block_pooled_dyn (_attn_block_pooled_dyn_kernel)
//
// The TPU kernels run a whole block per grid step with the layer weights
// resident in VMEM, because their VMEM holds megabytes and the grid runs in
// order. A Hopper block has at most 227 KB of shared memory and blocks run in
// parallel, so a block here is a chain of launches on one stream:
//
//   layernorm_kernel   f32 statistics (E[x^2] - E[x]^2, flax numerics), bf16 out
//   gemm_kernel        bf16 WMMA tiles, f32 accumulation, fused epilogue:
//                      bias | bias + activation | bias + residual add
//   attention_kernel   one (batch, head) per block: Q, K, V of the whole short
//                      sequence (SP <= 128, head_dim 64) in shared memory,
//                      S = QK^T and O = PV on the tensor cores, f32 softmax
//   attention_pooled_kernel
//                      one query row per (batch, head): the pooled last layer
//
// What bounds them on the H100: at the ViT-B/32 shapes (12,800 rows of 768)
// the GEMMs hold ~90% of the block's FLOPs and are compute-bound, so the
// GEMM's tensor-core rate decides the block's time; the LayerNorm, softmax and
// epilogues are bandwidth passes over activations that stay in L2 at these
// sizes. This first version keeps the design simple (WMMA 16x16x16 fragments
// fed by a 4-stage cp.async pipeline, no TMA, no wgmma), so it reaches a
// fraction of the card's bf16 peak; a TMA + wgmma GEMM is later work.
//
// Rounding points follow the TPU kernels: LN(x) rounds to x's dtype and the
// tensor cores take bf16 operands (DEFAULT-precision MXU dots truncate f32 to
// bf16 the same way), so every operand buffer between the launches is bf16;
// qkv, the fc output and the attention output round once, after the bias or
// the f32 accumulation; residual adds happen in x's dtype (f32 or bf16).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kEps = 1e-5f;
constexpr int kHeadDim = 64;
constexpr int kMaxSeq = 128;
constexpr float kScale = 0.125f;  // 1 / sqrt(kHeadDim)

enum Epilogue { kBias = 0, kBiasAct = 1, kBiasResidual = 2 };
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

// A row of a GEMM operand, optionally gathered: row m of the logical matrix
// lies at row m * sp + pooled_row(m) of the stored one. The pooled blocks use
// it to read one token per example out of the (B * SP, D) stream.
struct RowMap {
  const int* rows;
  int row0;
  int sp;
  int gather;
};

__device__ __forceinline__ size_t map_row(const RowMap& g, int m) {
  if (!g.gather) return (size_t)m;
  return (size_t)m * g.sp + pooled_row(g.rows, g.row0, m, g.sp);
}

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row, f32 statistics, bf16 output (the GEMM operand)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, bf16* __restrict__ y, int M,
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
  bf16* yr = y + (size_t)row * D;
  for (int i = lane; i < D; i += 32)
    yr[i] = __float2bfloat16((to_f(xr[i]) - mean) * (rs * scale[i]) + bias[i]);
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

template <typename TO, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const bf16* __restrict__ A, int lda, RowMap amap,
            const bf16* __restrict__ W, int ldw,
            const bf16* __restrict__ bias, TO* __restrict__ out, int ldo,
            const TO* __restrict__ res, int ldr, RowMap rmap, int M, int N,
            int K, int act) {
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
          if (EPI == kBiasAct) v = activation(v, act);
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
// attention over a short sequence: one block (4 warps) per (head, batch)
// qkv (B * SP, 3D) bf16 rows [q | k | v]; att (B * SP, D) bf16
// ---------------------------------------------------------------------------

constexpr int QK_LD = kHeadDim + 8;

__host__ __device__ inline int attn_s_ld(int spp) {
  return (spp > kHeadDim ? spp : kHeadDim) + 4;
}

inline size_t attn_smem_bytes(int spp) {
  return (size_t)3 * spp * QK_LD * sizeof(bf16) +
         (size_t)spp * attn_s_ld(spp) * sizeof(float) +
         (size_t)spp * (spp + 8) * sizeof(bf16);
}

__global__ void __launch_bounds__(128)
attention_kernel(const bf16* __restrict__ qkv, int D, bf16* __restrict__ att,
                 int SP, int SPp, int n_valid, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldq = 3 * D;
  const int S_LD = attn_s_ld(SPp), P_LD = SPp + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + SPp * QK_LD;
  bf16* Vs = Ks + SPp * QK_LD;
  float* Ss = reinterpret_cast<float*>(Vs + SPp * QK_LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + SPp * S_LD);

  const bf16* base = qkv + (size_t)b * SP * ldq + h * kHeadDim;
  for (int c = tid; c < SPp * (kHeadDim / 8); c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 q = make_uint4(0u, 0u, 0u, 0u), k = q, v = q;
    if (r < SP) {
      const bf16* src = base + (size_t)r * ldq + col;
      q = *reinterpret_cast<const uint4*>(src);
      k = *reinterpret_cast<const uint4*>(src + D);
      v = *reinterpret_cast<const uint4*>(src + 2 * D);
    }
    *reinterpret_cast<uint4*>(Qs + r * QK_LD + col) = q;
    *reinterpret_cast<uint4*>(Ks + r * QK_LD + col) = k;
    *reinterpret_cast<uint4*>(Vs + r * QK_LD + col) = v;
  }
  __syncthreads();

  const int nt = SPp / 16;
  for (int t = warp; t < nt * nt; t += 4) {  // S = Q K^T
    const int i0 = (t / nt) * 16, j0 = (t % nt) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kHeadDim; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
      wmma::load_matrix_sync(a, Qs + i0 * QK_LD + kk, QK_LD);
      wmma::load_matrix_sync(bk, Ks + j0 * QK_LD + kk, QK_LD);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(Ss + i0 * S_LD + j0, acc, S_LD,
                            wmma::mem_row_major);
  }
  __syncthreads();

  for (int r = warp; r < SPp; r += 4) {  // f32 softmax, one warp per row
    float* srow = Ss + r * S_LD;
    float mx = -INFINITY;
    for (int j = lane; j < SPp; j += 32) {
      const bool keep = j < n_valid && (!causal || j <= r);
      if (keep) mx = fmaxf(mx, srow[j] * scale);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < SPp; j += 32) {
      const bool keep = j < n_valid && (!causal || j <= r);
      const float p = keep ? expf(srow[j] * scale - mx) : 0.f;
      srow[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < SPp; j += 32)
      Ps[r * P_LD + j] = __float2bfloat16(srow[j] / sum);
  }
  __syncthreads();

  for (int t = warp; t < nt * (kHeadDim / 16); t += 4) {  // O = P V
    const int i0 = (t / (kHeadDim / 16)) * 16, c0 = (t % (kHeadDim / 16)) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < SPp; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      wmma::load_matrix_sync(a, Ps + i0 * P_LD + k0, P_LD);
      wmma::load_matrix_sync(bv, Vs + k0 * QK_LD + c0, QK_LD);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(Ss + i0 * S_LD + c0, acc, S_LD,
                            wmma::mem_row_major);
  }
  __syncthreads();

  bf16* dst = att + (size_t)b * SP * D + h * kHeadDim;
  for (int e = tid; e < SP * kHeadDim; e += blockDim.x) {
    const int r = e / kHeadDim, c = e % kHeadDim;
    dst[(size_t)r * D + c] = __float2bfloat16(Ss[r * S_LD + c]);
  }
}

// ---------------------------------------------------------------------------
// pooled attention: one query row per (head, batch), 128 threads, key j on
// thread j. q (B, D) bf16; kv (B * SP, 2D) bf16 rows [k | v]; att (B, D) bf16
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128)
attention_pooled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                        int D, const int* __restrict__ rows, int row0,
                        bf16* __restrict__ att, int SP, int n_valid,
                        int causal, float scale) {
  __shared__ float qs[kHeadDim];
  __shared__ float ps[kMaxSeq];
  __shared__ float red[4];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldkv = 2 * D;
  const bf16* kvb = kv + (size_t)b * SP * ldkv;
  if (tid < kHeadDim)
    qs[tid] = __bfloat162float(q[(size_t)b * D + h * kHeadDim + tid]);
  __syncthreads();

  const int row = pooled_row(rows, row0, b, SP);
  const bool keep = tid < SP && tid < n_valid && (!causal || tid <= row);
  float l = -INFINITY;
  if (keep) {
    const bf16* kr = kvb + (size_t)tid * ldkv + h * kHeadDim;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < kHeadDim; ++c) s += qs[c] * __bfloat162float(kr[c]);
    l = s * scale;
  }
  float m = warp_max(l);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  const float p = keep ? expf(l - m) : 0.f;
  float sum = warp_sum(p);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = red[0] + red[1] + red[2] + red[3];
  // p rounds to bf16 before the PV product, as p.astype(v.dtype) does
  ps[tid] = __bfloat162float(__float2bfloat16(p / sum));
  __syncthreads();

  if (tid < kHeadDim) {
    const bf16* vb = kvb + D + h * kHeadDim + tid;
    float o = 0.f;
    for (int j = 0; j < SP; ++j)
      o += ps[j] * __bfloat162float(vb[(size_t)j * ldkv]);
    att[(size_t)b * D + h * kHeadDim + tid] = __float2bfloat16(o);
  }
}

// ---------------------------------------------------------------------------
// host-side launch helpers
// ---------------------------------------------------------------------------

const RowMap kNoMap = {nullptr, 0, 0, 0};

template <typename T>
cudaError_t launch_layernorm(const void* x, const float* s, const float* b,
                             bf16* y, int M, int D, cudaStream_t st) {
  layernorm_kernel<T><<<(M + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(x), s, b, y, M, D);
  return cudaGetLastError();
}

cudaError_t layernorm(const void* x, int x_f32, const float* s, const float* b,
                      bf16* y, int M, int D, cudaStream_t st) {
  return x_f32 ? launch_layernorm<float>(x, s, b, y, M, D, st)
               : launch_layernorm<bf16>(x, s, b, y, M, D, st);
}

template <typename TO, int EPI>
cudaError_t gemm(const bf16* A, int lda, RowMap amap, const bf16* W, int ldw,
                 const bf16* bias, TO* out, int ldo, const TO* res, int ldr,
                 RowMap rmap, int M, int N, int K, int act, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<TO, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<TO, EPI><<<grid, kGemmThreads, kGemmSmem, st>>>(
      A, lda, amap, W, ldw, bias, out, ldo, res, ldr, rmap, M, N, K, act);
  return cudaGetLastError();
}

// out = res + (A W + bias) in x's dtype
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

extern "C" {

// x + out_proj(MHA(LN1(x))): x (B, SP, D) f32 or bf16 -> out, same shape and
// dtype. Scratch (bf16): y (B*SP, D), qkv (B*SP, 3D), att (B*SP, D).
int wt_attn_block(const void* x, int x_f32, const float* ln_s,
                  const float* ln_b, const bf16* wqkv, const bf16* bqkv,
                  const bf16* wo, const bf16* bo, void* out, bf16* y,
                  bf16* qkv, bf16* att, int B, int SP, int D, int H,
                  int n_valid, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * SP;
  if (SP < 1 || SP > kMaxSeq || D != H * kHeadDim) return (int)cudaErrorInvalidValue;
  WT_CHECK(layernorm(x, x_f32, ln_s, ln_b, y, M, D, st));
  WT_CHECK((gemm<bf16, kBias>(y, D, kNoMap, wqkv, 3 * D, bqkv, qkv, 3 * D,
                              nullptr, 0, kNoMap, M, 3 * D, D, kNone, st)));
  const int spp = (SP + 15) / 16 * 16;
  const size_t smem = attn_smem_bytes(spp);
  WT_CHECK(cudaFuncSetAttribute(attention_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
  attention_kernel<<<dim3(H, B), 128, smem, st>>>(
      qkv, D, att, SP, spp, n_valid, causal, kScale);
  WT_CHECK(cudaGetLastError());
  WT_CHECK(gemm_residual(att, D, kNoMap, wo, D, bo, out, D, x, D, kNoMap,
                         x_f32, M, D, D, st));
  return 0;
}

// x + proj(act(fc(LN2(x)))): scratch (bf16) y (M, D), h (M, F).
int wt_mlp_block(const void* x, int x_f32, const float* ln_s,
                 const float* ln_b, const bf16* wfc, const bf16* bfc,
                 const bf16* wproj, const bf16* bproj, void* out, bf16* y,
                 bf16* h, int M, int D, int F, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WT_CHECK(layernorm(x, x_f32, ln_s, ln_b, y, M, D, st));
  WT_CHECK((gemm<bf16, kBiasAct>(y, D, kNoMap, wfc, F, bfc, h, F, nullptr, 0,
                                 kNoMap, M, F, D, act, st)));
  WT_CHECK(gemm_residual(h, F, kNoMap, wproj, D, bproj, out, D, x, D, kNoMap,
                         x_f32, M, D, F, st));
  return 0;
}

// The attention block at one row per example, as (B, D): rows[b] when rows
// is given (device int32), else pool_row for every example. k/v cover every
// row; q, attention and out-proj only the pooled one. Scratch (bf16):
// y (B*SP, D), kv (B*SP, 2D), q (B, D), att (B, D).
int wt_attn_block_pooled(const void* x, int x_f32, const float* ln_s,
                         const float* ln_b, const bf16* wqkv,
                         const bf16* bqkv, const bf16* wo, const bf16* bo,
                         const int* rows, int pool_row, void* out, bf16* y,
                         bf16* kv, bf16* q, bf16* att, int B, int SP, int D,
                         int H, int n_valid, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * SP;
  if (SP < 1 || SP > kMaxSeq || D != H * kHeadDim) return (int)cudaErrorInvalidValue;
  const RowMap pooled = {rows, pool_row, SP, 1};
  WT_CHECK(layernorm(x, x_f32, ln_s, ln_b, y, M, D, st));
  WT_CHECK((gemm<bf16, kBias>(y, D, kNoMap, wqkv + D, 3 * D, bqkv + D, kv,
                              2 * D, nullptr, 0, kNoMap, M, 2 * D, D, kNone,
                              st)));
  WT_CHECK((gemm<bf16, kBias>(y, D, pooled, wqkv, 3 * D, bqkv, q, D, nullptr,
                              0, kNoMap, B, D, D, kNone, st)));
  attention_pooled_kernel<<<dim3(H, B), 128, 0, st>>>(
      q, kv, D, rows, pool_row, att, SP, n_valid, causal,
      kScale);
  WT_CHECK(cudaGetLastError());
  WT_CHECK(gemm_residual(att, D, kNoMap, wo, D, bo, out, D, x, D, pooled,
                         x_f32, B, D, D, st));
  return 0;
}

}  // extern "C"
