#pragma once

// Short-sequence attention on the tensor cores, shared by block_kernels.cu
// (the CLIP towers' pre-LN blocks and the attention-middle entry point) and
// postln_kernels.cu (the XLM-R tower's post-LN block). Internal linkage, as
// common.cuh: each translation unit holds its own copy.

#include "common.cuh"

namespace {

// The longest sequence the attention kernels take. K and V of one head stay
// resident in shared memory for the whole block: at head_dim 80 and 272 keys
// they hold 2 * 272 * 88 * 2 = 95,744 bytes, and with a 64-row query tile,
// its f32 scores and its bf16 probabilities the block needs 213,504 of
// Hopper's 232,448 bytes. 272 = 17 * 16 covers the 257 tokens of the /14
// towers at 224 px.
constexpr int kMaxSeq = 272;
constexpr int kAttnThreads = 256;

// ---------------------------------------------------------------------------
// attention over a short sequence: one block (8 warps) per (head, batch,
// query tile). q, k, v are (B * SP, D) bf16 matrices with row strides ldq,
// ldk, ldv (a packed qkv buffer is q = qkv, k = qkv + D, v = qkv + 2D with
// stride 3D; three tensors of their own have stride D); att (B * SP, D)
// bf16. logit = q . k * scale (+ km[b, j], an additive f32 key mask per
// example, where km is given); keys >= n_valid and, with causal, keys above
// the query row are dropped. A row whose keys are all dropped or at -inf
// comes out as NaN (0 / 0), as softmax over an empty set does.
// Rows SP..SPp-1 (SPp = SP rounded up to 16) are the kernel's own zero
// padding: masked as keys (n_valid <= SP), never stored as queries.
// ---------------------------------------------------------------------------

// Query rows per block (kQTile). One block per SM fits either way (K and V
// alone take 96 KB of the SM's 228 KB at 257 tokens and head_dim 80), so 64
// rows rather than 32 where they fit: K and V are loaded 5 times per head
// instead of 9, and 8 warps share 4 x 17 score tiles. At head_dim 128 (the
// padded-head block's 128-lane slots) a 64-row tile needs 271,872 bytes at
// 272 keys, over the 232,448 a block may take; 32 rows need 209,920. A full
// row of S fits in shared memory, so the softmax is one pass: no online
// rescaling at these lengths.
template <int HD>
struct AttnLayout {
  static constexpr int kQTile = HD > 80 ? 32 : 64;
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
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, int ldq, int ldk, int ldv,
                 const float* __restrict__ km, bf16* __restrict__ att, int D,
                 int SP, int SPp, int n_valid, int causal, float scale) {
  using L = AttnLayout<HD>;
  constexpr int QK_LD = L::QK_LD, kChunks = HD / 8, kWarps = kAttnThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * L::kQTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = min(L::kQTile, SPp - q0);  // rows of this tile, % 16 == 0
  const int S_LD = L::s_ld(SPp), P_LD = SPp + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + SPp * QK_LD;
  bf16* Qs = Vs + SPp * QK_LD;
  float* Ss = reinterpret_cast<float*>(Qs + L::q_rows(SPp) * QK_LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + L::q_rows(SPp) * S_LD);

  const size_t row0 = (size_t)b * SP;  // the example's first row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < SPp * kChunks; c += kAttnThreads) {
    const int r = c / kChunks, col = h * HD + (c % kChunks) * 8;
    uint4 kc = zero, vc = zero;
    if (r < SP) {
      kc = *reinterpret_cast<const uint4*>(k + (row0 + r) * ldk + col);
      vc = *reinterpret_cast<const uint4*>(v + (row0 + r) * ldv + col);
    }
    const int dst = r * QK_LD + (c % kChunks) * 8;
    *reinterpret_cast<uint4*>(Ks + dst) = kc;
    *reinterpret_cast<uint4*>(Vs + dst) = vc;
  }
  for (int c = tid; c < qt * kChunks; c += kAttnThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 qc = zero;
    if (q0 + r < SP)
      qc = *reinterpret_cast<const uint4*>(q + (row0 + q0 + r) * ldq +
                                           h * HD + col);
    *reinterpret_cast<uint4*>(Qs + r * QK_LD + col) = qc;
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
    const float* kmb = km ? km + row0 : nullptr;
    float mx = -INFINITY;
    for (int j = lane; j < SPp; j += 32) {
      const bool keep = j < n_valid && (!causal || j <= row);
      const float l =
          keep ? srow[j] * scale + (kmb ? kmb[j] : 0.f) : -INFINITY;
      srow[j] = l;
      mx = fmaxf(mx, l);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < SPp; j += 32) {
      const float p = srow[j] == -INFINITY ? 0.f : expf(srow[j] - mx);
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
  bf16* dst = att + (row0 + q0) * D + h * HD;
  for (int e = tid; e < rows * HD; e += kAttnThreads) {
    const int r = e / HD, c = e % HD;
    dst[(size_t)r * D + c] = __float2bfloat16(Ss[r * S_LD + c]);
  }
}

template <int HD>
cudaError_t launch_attention(const bf16* q, const bf16* k, const bf16* v,
                             int ldq, int ldk, int ldv, const float* km,
                             bf16* att, int D, int B, int SP, int H,
                             int n_valid, int causal, float scale,
                             cudaStream_t st) {
  const int spp = (SP + 15) / 16 * 16;
  using L = AttnLayout<HD>;
  const size_t smem = L::smem_bytes(spp);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  attention_kernel<HD><<<dim3(H, B, (spp + L::kQTile - 1) / L::kQTile),
                         kAttnThreads, smem, st>>>(
      q, k, v, ldq, ldk, ldv, km, att, D, SP, spp, n_valid, causal, scale);
  return cudaGetLastError();
}

// The attention of a (D, H) pair at its head_dim: 64 or 80 (head_dim()), or
// 128 for the attention-middle entry alone (short_head_dim()).
inline cudaError_t attention(int hd, const bf16* q, const bf16* k,
                             const bf16* v, int ldq, int ldk, int ldv,
                             const float* km, bf16* att, int D, int B, int SP,
                             int H, int n_valid, int causal, float scale,
                             cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch_attention<64>(q, k, v, ldq, ldk, ldv, km, att, D, B, SP,
                                  H, n_valid, causal, scale, st);
    case 80:
      return launch_attention<80>(q, k, v, ldq, ldk, ldv, km, att, D, B, SP,
                                  H, n_valid, causal, scale, st);
    case 128:
      return launch_attention<128>(q, k, v, ldq, ldk, ldv, km, att, D, B, SP,
                                   H, n_valid, causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// attention over a packed qkv buffer (B * SP, 3D) at the scale 1/sqrt(hd)
inline cudaError_t attention_packed(int hd, const bf16* qkv, const float* km,
                                    bf16* att, int D, int B, int SP, int H,
                                    int n_valid, int causal, cudaStream_t st) {
  return attention(hd, qkv, qkv + D, qkv + 2 * D, 3 * D, 3 * D, 3 * D, km, att,
                   D, B, SP, H, n_valid, causal, 1.0f / sqrtf((float)hd), st);
}

// head_dim of a (D, H) pair the block kernels take (64 or 80), else 0
inline int head_dim(int SP, int D, int H) {
  if (SP < 1 || SP > kMaxSeq || H < 1 || D % H != 0) return 0;
  const int hd = D / H;
  return hd == 64 || hd == 80 ? hd : 0;
}

// head_dim of a (D, H) pair the attention-middle entry takes: the block
// kernels' two, and 128, the padded-head block's zero-padded slots
inline int short_head_dim(int SP, int D, int H) {
  if (SP < 1 || SP > kMaxSeq || H < 1 || D % H != 0) return 0;
  const int hd = D / H;
  return hd == 128 ? hd : head_dim(SP, D, H);
}

}  // namespace
