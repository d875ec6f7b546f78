// Transformer-block kernels for Hopper (sm_90a): the CLIP towers' residual
// blocks as short chains of hand-written kernels.
//
// Replaces the Pallas TPU kernels of wise_tpu/ops/block.py:
//   wt_attn_block         <- fused_attn_block            (_attn_block_kernel)
//   wt_mlp_block          <- fused_mlp_block             (_mlp_block_kernel)
//   wt_attn_block_pooled  <- fused_attn_block_pooled     (_attn_block_pooled_kernel)
//                            fused_attn_block_pooled_dyn (_attn_block_pooled_dyn_kernel)
//   wt_mlp_fc, wt_mlp_proj <- fused_mlp_split            (_fc_kernel, _proj_kernel)
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
//   attention_kernel   one (head, batch, tile of 64 query rows) per block, for
//                      head_dim 64 or 80 and up to 272 keys: K and V of the
//                      whole sequence and the Q tile in shared memory,
//                      S = QK^T and O = PV on the tensor cores, f32 softmax
//   attention_pooled_kernel
//                      one query row per (batch, head): the pooled last layer
//
// The MLP has one chain in two halves: wt_mlp_fc (LayerNorm, fc GEMM with the
// bias + activation epilogue, h to device memory) and wt_mlp_proj (proj GEMM
// over h with the bias + residual epilogue). wt_mlp_block runs both on
// scratch of its own; the split pair hands h to the caller, as on the TPU,
// where the split exists because both weights do not fit VMEM above width
// 768. Here no weight is resident, so the two wrappers differ only in who
// owns h.
//
// What bounds them on the H100: the GEMMs hold ~90% of a block's FLOPs and
// are compute-bound at the towers' batch sizes, so the GEMM's tensor-core rate
// decides the block's time; the LayerNorm, softmax and epilogues are
// bandwidth passes over activations. This version keeps the design simple
// (WMMA 16x16x16 fragments fed by a 4-stage cp.async pipeline, no TMA, no
// wgmma), so it reaches a fraction of the card's bf16 peak; a TMA + wgmma
// GEMM is later work.
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

// The longest sequence the attention kernels take. K and V of one head stay
// resident in shared memory for the whole block: at head_dim 80 and 272 keys
// they hold 2 * 272 * 88 * 2 = 95,744 bytes, and with a 64-row query tile,
// its f32 scores and its bf16 probabilities the block needs 213,504 of
// Hopper's 232,448 bytes. 272 = 17 * 16 covers the 257 tokens of the /14
// towers at 224 px.
constexpr int kMaxSeq = 272;

// Query rows per block. One block per SM fits either way (K and V alone take
// 96 KB of the SM's 228 KB at 257 tokens), so 64 rows rather than 32: K and V
// are loaded 5 times per head instead of 9, and 8 warps share 4 x 17 score
// tiles. A full row of S fits in shared memory, so the softmax is one pass:
// no online rescaling at these lengths.
constexpr int kQTile = 64;
constexpr int kAttnThreads = 256;

// ---------------------------------------------------------------------------
// attention over a short sequence: one block (8 warps) per (head, batch,
// query tile). qkv (B * SP, 3D) bf16 rows [q | k | v]; att (B * SP, D) bf16.
// Rows SP..SPp-1 (SPp = SP rounded up to 16) are the kernel's own zero
// padding: masked as keys (n_valid <= SP), never stored as queries.
// ---------------------------------------------------------------------------

template <int HD>
struct AttnLayout {
  static constexpr int QK_LD = HD + 8;  // +8 bf16: rows stay 16-byte aligned
  __host__ __device__ static int s_ld(int spp) {
    return (spp > HD ? spp : HD) + 4;  // S rows also stage the O tile
  }
  __host__ __device__ static int q_rows(int spp) {
    return spp < kQTile ? spp : kQTile;
  }
  static size_t smem_bytes(int spp) {
    const int qt = q_rows(spp);
    return (size_t)(2 * spp + qt) * QK_LD * sizeof(bf16) +
           (size_t)qt * s_ld(spp) * sizeof(float) +
           (size_t)qt * (spp + 8) * sizeof(bf16);
  }
};

template <int HD>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const bf16* __restrict__ qkv, int D, bf16* __restrict__ att,
                 int SP, int SPp, int n_valid, int causal, float scale) {
  using L = AttnLayout<HD>;
  constexpr int QK_LD = L::QK_LD, kChunks = HD / 8, kWarps = kAttnThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * kQTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldq = 3 * D;
  const int qt = min(kQTile, SPp - q0);  // query rows of this tile, % 16 == 0
  const int S_LD = L::s_ld(SPp), P_LD = SPp + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + SPp * QK_LD;
  bf16* Qs = Vs + SPp * QK_LD;
  float* Ss = reinterpret_cast<float*>(Qs + L::q_rows(SPp) * QK_LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + L::q_rows(SPp) * S_LD);

  const bf16* base = qkv + (size_t)b * SP * ldq + h * HD;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < SPp * kChunks; c += kAttnThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 k = zero, v = zero;
    if (r < SP) {
      const bf16* src = base + (size_t)r * ldq + col;
      k = *reinterpret_cast<const uint4*>(src + D);
      v = *reinterpret_cast<const uint4*>(src + 2 * D);
    }
    *reinterpret_cast<uint4*>(Ks + r * QK_LD + col) = k;
    *reinterpret_cast<uint4*>(Vs + r * QK_LD + col) = v;
  }
  for (int c = tid; c < qt * kChunks; c += kAttnThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 q = zero;
    if (q0 + r < SP)
      q = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * ldq + col);
    *reinterpret_cast<uint4*>(Qs + r * QK_LD + col) = q;
  }
  __syncthreads();

  const int nt = SPp / 16, qtiles = qt / 16;
  for (int t = warp; t < qtiles * nt; t += kWarps) {  // S = Q K^T
    const int i0 = (t / nt) * 16, j0 = (t % nt) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
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

  for (int r = warp; r < qt; r += kWarps) {  // f32 softmax, one warp per row
    float* srow = Ss + r * S_LD;
    const int row = q0 + r;
    float mx = -INFINITY;
    for (int j = lane; j < SPp; j += 32) {
      const bool keep = j < n_valid && (!causal || j <= row);
      if (keep) mx = fmaxf(mx, srow[j] * scale);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < SPp; j += 32) {
      const bool keep = j < n_valid && (!causal || j <= row);
      const float p = keep ? expf(srow[j] * scale - mx) : 0.f;
      srow[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < SPp; j += 32)
      Ps[r * P_LD + j] = __float2bfloat16(srow[j] / sum);
  }
  __syncthreads();

  constexpr int kColTiles = HD / 16;
  for (int t = warp; t < qtiles * kColTiles; t += kWarps) {  // O = P V
    const int i0 = (t / kColTiles) * 16, c0 = (t % kColTiles) * 16;
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

  const int rows = min(qt, SP - q0);  // the tile's rows that exist
  bf16* dst = att + ((size_t)b * SP + q0) * D + h * HD;
  for (int e = tid; e < rows * HD; e += kAttnThreads) {
    const int r = e / HD, c = e % HD;
    dst[(size_t)r * D + c] = __float2bfloat16(Ss[r * S_LD + c]);
  }
}

template <int HD>
cudaError_t launch_attention(const bf16* qkv, int D, bf16* att, int B, int SP,
                             int H, int n_valid, int causal, cudaStream_t st) {
  const int spp = (SP + 15) / 16 * 16;
  const size_t smem = AttnLayout<HD>::smem_bytes(spp);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  attention_kernel<HD>
      <<<dim3(H, B, (spp + kQTile - 1) / kQTile), kAttnThreads, smem, st>>>(
          qkv, D, att, SP, spp, n_valid, causal, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pooled attention: one query row per (head, batch), 128 threads looping
// over the keys. q (B, D) bf16; kv (B * SP, 2D) bf16 rows [k | v];
// att (B, D) bf16. Dynamic shared memory: SP floats (logits, then p).
// ---------------------------------------------------------------------------

constexpr int kPoolThreads = 128;

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return is_max ? fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]))
                : red[0] + red[1] + red[2] + red[3];
}

template <int HD>
__global__ void __launch_bounds__(kPoolThreads)
attention_pooled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                        int D, const int* __restrict__ rows, int row0,
                        bf16* __restrict__ att, int SP, int n_valid,
                        int causal, float scale) {
  extern __shared__ float ps[];  // SP
  __shared__ float qs[HD];
  __shared__ float red[kPoolThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ldkv = 2 * D;
  const bf16* kvb = kv + (size_t)b * SP * ldkv + h * HD;
  if (tid < HD) qs[tid] = __bfloat162float(q[(size_t)b * D + h * HD + tid]);
  __syncthreads();

  const int row = pooled_row(rows, row0, b, SP);
  float m = -INFINITY;
  for (int j = tid; j < SP; j += kPoolThreads) {
    float l = -INFINITY;
    if (j < n_valid && (!causal || j <= row)) {
      const bf16* kr = kvb + (size_t)j * ldkv;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < HD; ++c) s += qs[c] * __bfloat162float(kr[c]);
      l = s * scale;
    }
    ps[j] = l;
    m = fmaxf(m, l);
  }
  m = block_reduce(m, red, true);
  float sum = 0.f;
  for (int j = tid; j < SP; j += kPoolThreads) {
    const float p = ps[j] == -INFINITY ? 0.f : expf(ps[j] - m);
    ps[j] = p;
    sum += p;
  }
  sum = block_reduce(sum, red, false);
  // p rounds to bf16 before the PV product, as p.astype(v.dtype) does
  for (int j = tid; j < SP; j += kPoolThreads)
    ps[j] = __bfloat162float(__float2bfloat16(ps[j] / sum));
  __syncthreads();

  if (tid < HD) {
    const bf16* vb = kvb + D + tid;
    float o = 0.f;
    for (int j = 0; j < SP; ++j)
      o += ps[j] * __bfloat162float(vb[(size_t)j * ldkv]);
    att[(size_t)b * D + h * HD + tid] = __float2bfloat16(o);
  }
}

template <int HD>
cudaError_t launch_attention_pooled(const bf16* q, const bf16* kv, int D,
                                    const int* rows, int row0, bf16* att,
                                    int B, int SP, int H, int n_valid,
                                    int causal, cudaStream_t st) {
  attention_pooled_kernel<HD>
      <<<dim3(H, B), kPoolThreads, SP * sizeof(float), st>>>(
          q, kv, D, rows, row0, att, SP, n_valid, causal,
          1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// head_dim of a (D, H) pair the kernels take (64 or 80), else 0
inline int head_dim(int SP, int D, int H) {
  if (SP < 1 || SP > kMaxSeq || H < 1 || D % H != 0) return 0;
  const int hd = D / H;
  return hd == 64 || hd == 80 ? hd : 0;
}

// h = act(fc(LN(x))) as (M, F) bf16; scratch y (M, D) bf16
cudaError_t mlp_fc(const void* x, int x_f32, const float* ln_s,
                   const float* ln_b, const bf16* wfc, const bf16* bfc,
                   bf16* h, bf16* y, int M, int D, int F, int act,
                   cudaStream_t st) {
  cudaError_t err = layernorm(x, x_f32, ln_s, ln_b, y, M, D, st);
  if (err != cudaSuccess) return err;
  return gemm<bf16, kBiasAct>(y, D, kNoMap, wfc, F, bfc, h, F, nullptr, 0,
                              kNoMap, M, F, D, act, st);
}

// out = x + (proj(h) + b) in x's dtype
cudaError_t mlp_proj(const bf16* h, const bf16* wproj, const bf16* bproj,
                     const void* x, int x_f32, void* out, int M, int D, int F,
                     cudaStream_t st) {
  return gemm_residual(h, F, kNoMap, wproj, D, bproj, out, D, x, D, kNoMap,
                       x_f32, M, D, F, st);
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
  const int hd = head_dim(SP, D, H);
  if (!hd) return (int)cudaErrorInvalidValue;
  WT_CHECK(layernorm(x, x_f32, ln_s, ln_b, y, M, D, st));
  WT_CHECK((gemm<bf16, kBias>(y, D, kNoMap, wqkv, 3 * D, bqkv, qkv, 3 * D,
                              nullptr, 0, kNoMap, M, 3 * D, D, kNone, st)));
  WT_CHECK(hd == 64
               ? launch_attention<64>(qkv, D, att, B, SP, H, n_valid, causal, st)
               : launch_attention<80>(qkv, D, att, B, SP, H, n_valid, causal, st));
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
  WT_CHECK(mlp_fc(x, x_f32, ln_s, ln_b, wfc, bfc, h, y, M, D, F, act, st));
  WT_CHECK(mlp_proj(h, wproj, bproj, x, x_f32, out, M, D, F, st));
  return 0;
}

// The first half of the split MLP: h = act(fc(LN2(x))) as (M, F) bf16 in
// the caller's memory. Scratch (bf16): y (M, D).
int wt_mlp_fc(const void* x, int x_f32, const float* ln_s, const float* ln_b,
              const bf16* wfc, const bf16* bfc, bf16* h, bf16* y, int M, int D,
              int F, int act, void* stream) {
  return (int)mlp_fc(x, x_f32, ln_s, ln_b, wfc, bfc, h, y, M, D, F, act,
                     static_cast<cudaStream_t>(stream));
}

// The second half: out = x + (proj(h) + b) in x's dtype.
int wt_mlp_proj(const bf16* h, const bf16* wproj, const bf16* bproj,
                const void* x, int x_f32, void* out, int M, int D, int F,
                void* stream) {
  return (int)mlp_proj(h, wproj, bproj, x, x_f32, out, M, D, F,
                       static_cast<cudaStream_t>(stream));
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
  const int hd = head_dim(SP, D, H);
  if (!hd) return (int)cudaErrorInvalidValue;
  const RowMap pooled = {rows, pool_row, SP, 1};
  WT_CHECK(layernorm(x, x_f32, ln_s, ln_b, y, M, D, st));
  WT_CHECK((gemm<bf16, kBias>(y, D, kNoMap, wqkv + D, 3 * D, bqkv + D, kv,
                              2 * D, nullptr, 0, kNoMap, M, 2 * D, D, kNone,
                              st)));
  WT_CHECK((gemm<bf16, kBias>(y, D, pooled, wqkv, 3 * D, bqkv, q, D, nullptr,
                              0, kNoMap, B, D, D, kNone, st)));
  WT_CHECK(hd == 64 ? launch_attention_pooled<64>(q, kv, D, rows, pool_row,
                                                  att, B, SP, H, n_valid,
                                                  causal, st)
                    : launch_attention_pooled<80>(q, kv, D, rows, pool_row,
                                                  att, B, SP, H, n_valid,
                                                  causal, st));
  WT_CHECK(gemm_residual(att, D, kNoMap, wo, D, bo, out, D, x, D, pooled,
                         x_f32, B, D, D, st));
  return 0;
}

}  // extern "C"
