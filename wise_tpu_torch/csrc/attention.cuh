#pragma once

// Short-sequence attention on the tensor cores, shared by block_kernels.cu
// (the CLIP towers' pre-LN blocks and the attention-middle entry point) and
// postln_kernels.cu (the XLM-R tower's post-LN block). Internal linkage, as
// common.cuh: each translation unit holds its own copy.
//
// Replaces the attention of the Pallas TPU kernels wise_tpu/ops/attention.py
// fused_short_attention (_kernel), and the attention middles of
// wise_tpu/ops/block.py _attn_block_kernel and wise_tpu/ops/postln_block.py
// _postln_attn_kernel. The TPU kernel holds q, k, v of a group of examples in
// VMEM and a whole (SP, SP) logits block per head; a Hopper SM has 227 KB of
// shared memory and 64K registers, so the kernel here is flash-style.
//
// What bounds it: it reads q, k, v and writes the output once, 8 M D bytes
// (bf16, M = B * SP), for 4 M keys D operations: keys / 2 operations a byte,
// under the card's ~295 at every length it takes, so bytes bound it (0.05 ms
// at ViT-H/14's 64 x 257 x 1280). What the design does about it:
//   - one block of 4 warps per (64-row query tile, head, example), the query
//     tile fastest in blockIdx.x, so that the tiles of one (example, head)
//     run together and find its K and V in L2: device memory sees them about
//     once;
//   - a loop over key tiles of 64, in two passes: the first reads K alone
//     and carries each row's max and sum online (f32 registers, the sum
//     rescaled by exp(m_old - m_new)); the second reads K and V of the same
//     tiles and adds bf16(p) V with p = exp(logit - m) / sum, which is where
//     the reference and the plain version round p. (One pass that rounds
//     exp(logit - m_running) and divides at the end rounds elsewhere: its
//     bf16-level difference from the plain path, over ViT-B/32's 12 layers,
//     took the served scores past chip_smoke's check; PERF.md §6.) K is
//     read twice, the second time from L2. The tiles pass through two
//     shared-memory stages filled by 16-byte cp.async copies, the next tile
//     in flight while the tensor cores work on this one; shared memory is
//     5 tiles of 64 rows whatever SP is (46-87 KB), so 2-4 blocks share an
//     SM;
//   - S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in, f32
//     accumulation): each warp owns 16 query rows, its Q fragments stay in
//     registers for the whole loop, S and P never leave registers (the S
//     accumulator of two 8-key n-tiles is the A fragment of one 16-key slice
//     of P V), K comes in by ldmatrix and V by ldmatrix.trans;
//   - the output is staged through the warp's own rows of the dead Q tile
//     and stored in 16-byte rows.
// Head dims 88 and 104 (ViT-g-14, ViT-bigG-14) are not a multiple of the
// m16n8k16 step: the tiles carry them zero-filled to 96 / 112 columns
// (attn_pad_dim), so QK^T takes one k16 step more, whose last 8 columns add
// 0 to every logit, and P V one 16-column pair of n-tiles more, whose last
// 8 columns come out 0 and are never stored (9% / 8% more tensor-core work
// than the true width, no tail code). The pad columns are zeroed once; the
// copies never write them.
// Shared rows are the padded head_dim and 8 bf16 more (144 / 176 / 208 /
// 240 / 272 bytes at head_dim 64 / 80 / 88 / 104 / 128): an odd count of
// 16-byte groups, so the 8 rows an ldmatrix reads fall in 8 distinct bank
// groups and it is free of bank conflicts (a row of HD + 8 would be 192 and
// 224 bytes at 88 and 104, even counts whose 8 rows share banks).

#include "mma.cuh"  // mma.sync and ldmatrix fragments (includes common.cuh)

namespace {

// The longest sequence the attention kernels take: the gates (head_dim(),
// short_head_dim(), ops/block.py MAX_SEQ) apply it. It is not a
// shared-memory limit (the key loop's memory does not grow with SP): ten key
// tiles, which cover the 576 tokens of SigLIP at 384 px (24 x 24 patches, no
// class token) and the 577 of ViT-L/14 at 336 px.
constexpr int kMaxSeq = 640;
constexpr int kQTile = 64, kKTile = 64, kAttnWarps = kQTile / 16;
constexpr int kAttnThreads = 32 * kAttnWarps;

// head_dim rounded up to the m16n8k16 step: the tiles' columns
template <int HD>
__host__ __device__ constexpr int attn_pad_dim() {
  return (HD + 15) / 16 * 16;
}
// bf16 a shared row holds past the padded head_dim
constexpr int kAttnRowPad = 8;
template <int HD>
__host__ __device__ constexpr int attn_ld() {
  return attn_pad_dim<HD>() + kAttnRowPad;
}

// shared memory of one block: the Q tile and two stages of K and V
template <int HD>
constexpr size_t attn_smem_bytes() {
  return (size_t)(kQTile + 4 * kKTile) * attn_ld<HD>() * sizeof(bf16);
}

// ---------------------------------------------------------------------------
// attention over a short sequence: one block (4 warps) per (query tile of
// 64 rows, head, example). q, k, v are (B * SP, D) bf16 matrices with row
// strides ldq, ldk, ldv (a packed qkv buffer is q = qkv, k = qkv + D,
// v = qkv + 2D with stride 3D; three tensors of their own have stride D);
// att (B * SP, D) bf16. logit = q . k * scale (+ km[b, j], an additive f32
// key mask per example, where km is given); keys >= n_valid and, with
// causal, keys above the query row are dropped. A row whose keys are all
// dropped or at -inf comes out as NaN (0 / 0), as softmax over an empty set
// does. Query rows >= SP are zeros in the Q tile and never stored; key rows
// >= SP (and past the last key any row of the block keeps) are zeros in the
// K and V tiles and masked.
//
// Per row, f32 registers carry the running max m and the thread's share of
// the running sum l; in the first pass a key tile scales l by
// exp(m_old - m_new) and adds exp(logit - m_new) to it. While m is -inf (no
// kept key yet) it counts as 0 there, so that exp(-inf - -inf) cannot poison
// a row that later finds a kept key. The second pass adds
// bf16(exp(logit - m) / l) V to O, in f32; a row with no kept key divides 0
// by 0. expf and the division are the accurate ones, as in the plain
// version's softmax.
// ---------------------------------------------------------------------------

template <int HD>
__device__ __forceinline__ void attention_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, int ldq, int ldk, int ldv,
    const float* __restrict__ km, bf16* __restrict__ att, int D, int SP,
    int n_valid, int causal, float scale) {
  // kChunks: 16-byte chunks of a head's row in device memory; kSteps: k16
  // steps of the padded row (a bare HD / 16 would drop the last 8 columns
  // at 88 and 104)
  constexpr int HP = attn_pad_dim<HD>(), LD = attn_ld<HD>();
  constexpr int kChunks = HD / 8, kSteps = HP / 16;
  static_assert(HD % 8 == 0 && HP - HD <= 8, "one 16-byte pad chunk a row");
  constexpr int kTile = kKTile * LD;  // elements of one K or V stage
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kQTile * LD;
  bf16* Vs = Ks + 2 * kTile;
  if constexpr (HP > HD) {  // the pad columns of Q, both K and both V stages
    for (int r = threadIdx.x; r < kQTile + 4 * kKTile; r += kAttnThreads)
      *reinterpret_cast<uint4*>(Qs + r * LD + HD) = make_uint4(0, 0, 0, 0);
  }

  const int q0 = blockIdx.x * kQTile, col0 = blockIdx.y * HD;
  const size_t row0 = (size_t)blockIdx.z * SP;  // the example's first row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int wrow = q0 + warp * 16;        // the warp's first query row
  const bool live = wrow < SP;            // the warp has a row to compute
  const int rows[2] = {wrow + g, wrow + g + 8};

  // keys any row of the block keeps: below n_valid and, with causal, up to
  // the block's last row
  const int kend = causal ? min(n_valid, min(q0 + kQTile, SP)) : n_valid;
  const int tiles = (kend + kKTile - 1) / kKTile;

  for (int c = tid; c < kQTile * kChunks; c += kAttnThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = q0 + r < SP;
    cp_async16(Qs + r * LD + col,
               q + (row0 + (ok ? q0 + r : 0)) * ldq + col0 + col, ok);
  }
  // 2 * tiles steps: pass 1 (step < tiles) reads K alone and carries the
  // row statistics, pass 2 reads K and V of the same tiles and adds P V
  auto load = [&](int step) {
    const bool with_v = step >= tiles;
    const int kt = with_v ? step - tiles : step;
    bf16* ks = Ks + (step & 1) * kTile;
    bf16* vs = Vs + (step & 1) * kTile;
    for (int c = tid; c < kKTile * kChunks; c += kAttnThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int j = kt * kKTile + r;
      const bool ok = j < kend;
      const size_t src = row0 + (ok ? j : 0);
      cp_async16(ks + r * LD + col, k + src * ldk + col0 + col, ok);
      if (with_v) cp_async16(vs + r * LD + col, v + src * ldv + col0 + col, ok);
    }
  };
  load(0);
  cp_async_commit();

  unsigned qf[kSteps][4];
  float o[2 * kSteps][4];
#pragma unroll
  for (int n = 0; n < 2 * kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, mu[2];

  for (int step = 0; step < 2 * tiles; ++step) {
    cp_async_wait<0>();  // this step's tile (and, at 0, the Q tile) landed
    __syncthreads();     // ... for every thread; every warp is done with the
                         // stage the next copy overwrites
    if (step + 1 < 2 * tiles) load(step + 1);
    cp_async_commit();
    if (step == 0 && live) {
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
        ldmatrix_x4(qf[st], Qs + (warp * 16 + (lane & 15)) * LD + st * 16 +
                                (lane >> 4) * 8);
    }
    const bool pass2 = step >= tiles;
    if (step == tiles) {  // the row statistics are final
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mu[r] = m[r] == -INFINITY ? 0.f : m[r];
        l[r] = quad_sum(l[r]);  // no kept key: 0, and p = 0 / 0
      }
    }
    const int j0 = (pass2 ? step - tiles : step) * kKTile;
    // a warp past SP, or (causal) wholly above this key tile, has nothing here
    if (!live || (causal && j0 > wrow + 15)) continue;
    const bf16* ks = Ks + (step & 1) * kTile;
    const bf16* vs = Vs + (step & 1) * kTile;

    // S = Q K^T: 8 n-tiles of 8 keys; one ldmatrix.x4 feeds two
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            st * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[st], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[st], bk[2], bk[3]);
      }
    }

    // scale and mask; element e of n-tile n is row rows[e / 2], key
    // j0 + 8 n + 2 t + e % 2
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + 2 * t + (e & 1);
        const bool keep = j < n_valid && (!causal || j <= rows[e >> 1]);
        s[n][e] =
            keep ? s[n][e] * scale + (km ? km[row0 + j] : 0.f) : -INFINITY;
      }
    }

    if (!pass2) {  // running max and sum, the -inf guard on the max
      float mt[2] = {m[0], m[1]}, u[2];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = quad_max(mt[r]);
        u[r] = mt[r] == -INFINITY ? 0.f : mt[r];
        l[r] *= expf(m[r] - u[r]);  // 0 while m was -inf
        m[r] = mt[r];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          l[e >> 1] += expf(s[n][e] - u[e >> 1]);  // -inf -> 0
      continue;
    }

    // O += bf16(p) V with p = exp(logit - m) / l: n-tiles 2 kk and 2 kk + 1
    // of S are the A fragment of key slice kk; one ldmatrix.x4.trans of V
    // feeds two 8-column n-tiles of O
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = expf(s[n][e] - mu[e >> 1]) / l[e >> 1];
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kSteps; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }
  if (!live) return;

  // O staged in the warp's own 16 rows of the Q tile (no other warp reads
  // them), then 16-byte stores of the HD true columns
  bf16* os = Qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < 2 * kSteps; ++n) {
    *reinterpret_cast<unsigned*>(os + g * LD + n * 8 + 2 * t) =
        pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<unsigned*>(os + (g + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    if (wrow + r < SP)
      *reinterpret_cast<uint4*>(att + (row0 + wrow + r) * D + col0 + col) =
          *reinterpret_cast<const uint4*>(os + r * LD + col);
  }
}

template <int HD>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, int ldq, int ldk, int ldv,
                 const float* __restrict__ km, bf16* __restrict__ att, int D,
                 int SP, int n_valid, int causal, float scale) {
  attention_tile<HD>(q, k, v, ldq, ldk, ldv, km, att, D, SP, n_valid, causal,
                     scale);
}

// At head_dim 104 the registers a thread takes unbounded (170, allocated as
// 176) leave 2 blocks an SM; a bound of 3 blocks caps them at 168 (16 bytes
// of spill), and 3 blocks' shared memory (3 x 76.8 KB and the 1 KB each
// reserves) is the SM's 228 KB. ViT-bigG-14's attention: 144.6 -> 112.9 ms
// of a 256-frame batch (PERF.md §6). The other head dims keep the unbounded
// build.
template <>
__global__ void __launch_bounds__(kAttnThreads, 3)
attention_kernel<104>(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, int ldq, int ldk, int ldv,
                      const float* __restrict__ km, bf16* __restrict__ att,
                      int D, int SP, int n_valid, int causal, float scale) {
  attention_tile<104>(q, k, v, ldq, ldk, ldv, km, att, D, SP, n_valid,
                      causal, scale);
}

template <int HD>
cudaError_t launch_attention(const bf16* q, const bf16* k, const bf16* v,
                             int ldq, int ldk, int ldv, const float* km,
                             bf16* att, int D, int B, int SP, int H,
                             int n_valid, int causal, float scale,
                             cudaStream_t st) {
  constexpr size_t smem = attn_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  attention_kernel<HD><<<dim3((SP + kQTile - 1) / kQTile, H, B),
                         kAttnThreads, smem, st>>>(
      q, k, v, ldq, ldk, ldv, km, att, D, SP, n_valid, causal, scale);
  return cudaGetLastError();
}

// The attention of a (D, H) pair at its head_dim: 64, 80, 88 or 104
// (head_dim()), or 128 for the attention-middle entry alone
// (short_head_dim()).
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
    case 88:
      return launch_attention<88>(q, k, v, ldq, ldk, ldv, km, att, D, B, SP,
                                  H, n_valid, causal, scale, st);
    case 104:
      return launch_attention<104>(q, k, v, ldq, ldk, ldv, km, att, D, B, SP,
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

// head_dim of a (D, H) pair the block kernels take (64, 80, 88 or 104),
// else 0
inline int head_dim(int SP, int D, int H) {
  if (SP < 1 || SP > kMaxSeq || H < 1 || D % H != 0) return 0;
  const int hd = D / H;
  return hd == 64 || hd == 80 || hd == 88 || hd == 104 ? hd : 0;
}

// head_dim of a (D, H) pair the attention-middle entry takes: the block
// kernels' four, and 128, the padded-head block's zero-padded slots
inline int short_head_dim(int SP, int D, int H) {
  if (SP < 1 || SP > kMaxSeq || H < 1 || D % H != 0) return 0;
  const int hd = D / H;
  return hd == 128 ? hd : head_dim(SP, D, H);
}

}  // namespace
