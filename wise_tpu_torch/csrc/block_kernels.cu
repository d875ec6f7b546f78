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
//                      (both in common.cuh, shared with swin_kernels.cu)
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

#include "common.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kMaxSeq = 128;
constexpr float kScale = 0.125f;  // 1 / sqrt(kHeadDim)

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
