// Swin-block kernels for Hopper (sm_90a): the windowed-attention blocks of
// CLAP's HTSAT audio tower as short chains of hand-written kernels.
//
// Replaces the Pallas TPU kernels:
//   wt_window_attention  <- wise_tpu/ops/swin_attention.py fused_window_attention
//   wt_swin_block        <- wise_tpu/ops/swin_block.py     fused_swin_block
//
// Both work on window-layout activations: x (N, L, C), N = batch x windows,
// L = window^2 tokens (64 for HTSAT's window 8), C channels, heads of
// head_dim C / H (24 at every HTSAT stage). The caller keeps roll, window
// partition and reverse as layout ops, as the TPU kernels' caller does.
//
//   wt_window_attention  qkv GEMM (+bias) -> window attention ->
//                        out-proj GEMM (+bias)
//   wt_swin_block        LN1 -> qkv GEMM -> window attention -> out-proj GEMM
//                        + residual -> LN2 -> fc1 GEMM + exact GELU ->
//                        fc2 GEMM + residual, all in the bf16 stream
//
// The LayerNorm and the GEMM with its epilogues are the CLIP blocks'
// (common.cuh). The GEMM takes 16-byte rows; HTSAT's K and N are 96, 192,
// 288, ... 3072, so the N edge of a 128-wide tile and the K edge of a 64-deep
// stage (K = 96) are zero-filled by TMA and masked in the epilogue, and no
// weight is padded.
//
// window_attention_kernel: one block of 4 warps per (window, head); the
// window index is the grid's x dimension (2^31 - 1), so stage 0 at batch 64
// (4,096 windows x 4 heads) and larger batches launch in one grid. Q, K and
// V of the head (L x head_dim) sit in shared memory as f32. head_dim 24 is
// not a multiple of the tensor cores' k = 16, and a window's QK^T and PV are
// 64 x 64 x 24 each (0.2 MFLOP per head, ~10% of the block's FLOPs at C = 96
// next to its GEMMs), so both products run as scalar f32 FMAs: a warp owns a
// query row, lane j holds keys j and j + 32 (K rows padded to 33 floats: no
// bank conflicts), and the softmaxed row is staged in shared memory for PV,
// where lane c sums column c of V. Logits are f32: QK^T * scale + bias[h] (+ the
// shift mask of window w mod n_win, the period the TPU kernel's index map
// i % period gives), an f32 softmax, P rounded to bf16 as p.astype(v.dtype)
// does, and the head's output written back in bf16.
//
// What bounds the block on the H100: at HTSAT's widths (C = 96 ... 768) the
// GEMMs are narrow and the window batch large (262,144 rows at stage 0 and
// batch 64). The chain moves ~52 bytes per token and channel through device
// memory (LN outputs, qkv, attention out, residual, the 4C MLP hidden, each
// written and read in bf16) against 24 C FLOPs, ~0.46 C FLOP per byte: under
// the card's ~295 bf16 FLOP per byte at C <= 384 (stages 0-2 are
// bandwidth-bound), near it at C = 768. This first version keeps the design
// simple: one launch per
// step, intermediates in device memory; fusing LN into the GEMM's operand
// load and the attention into the qkv GEMM is later work.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after each launch.

#include "common.cuh"

namespace {

constexpr int kWinMaxL = 64;    // tokens per window (window 8)
constexpr int kWinMaxHd = 32;   // head_dim bound (HTSAT: 24)
constexpr int kWinThreads = 128;
constexpr int kWinWarps = kWinThreads / 32;

// qkv (N * L, 3C) bf16 rows [q | k | v]; bias (H, L, L) f32; mask
// (n_win, L, L) f32 or null; att (N * L, C) bf16
__global__ void __launch_bounds__(kWinThreads)
window_attention_kernel(const bf16* __restrict__ qkv, int C,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, int n_win,
                        bf16* __restrict__ att, int L, int hd, float scale) {
  __shared__ float Qs[kWinMaxL][kWinMaxHd + 1];
  __shared__ float Ks[kWinMaxL][kWinMaxHd + 1];
  __shared__ float Vs[kWinMaxL][kWinMaxHd + 1];
  __shared__ float Ps[kWinWarps][kWinMaxL];
  const int w = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ld = 3 * C, chunks = hd / 8;

  // 16-byte loads: C and hd are multiples of 8, so every chunk is aligned
  const bf16* base = qkv + (size_t)w * L * ld + h * hd;
  for (int c = tid; c < L * chunks; c += kWinThreads) {
    const int r = c / chunks, col = (c % chunks) * 8;
    const bf16* src = base + (size_t)r * ld + col;
    const uint4 q = *reinterpret_cast<const uint4*>(src);
    const uint4 k = *reinterpret_cast<const uint4*>(src + C);
    const uint4 v = *reinterpret_cast<const uint4*>(src + 2 * C);
    const bf16* qe = reinterpret_cast<const bf16*>(&q);
    const bf16* ke = reinterpret_cast<const bf16*>(&k);
    const bf16* ve = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      Qs[r][col + e] = __bfloat162float(qe[e]);
      Ks[r][col + e] = __bfloat162float(ke[e]);
      Vs[r][col + e] = __bfloat162float(ve[e]);
    }
  }
  __syncthreads();

  const float* bh = bias + (size_t)h * L * L;
  const float* mw = mask ? mask + (size_t)(w % n_win) * L * L : nullptr;
  float* p = Ps[warp];
  for (int i = warp; i < L; i += kWinWarps) {
    float s[2];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < L) {
        float acc = 0.f;
        for (int c = 0; c < hd; ++c) acc += Qs[i][c] * Ks[j][c];
        float l = acc * scale + bh[i * L + j];
        if (mw) l += mw[i * L + j];
        s[t] = l;
        mx = fmaxf(mx, l);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float e = lane + 32 * t < L ? expf(s[t] - mx) : 0.f;
      s[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      if (j < L) p[j] = __bfloat162float(__float2bfloat16(s[t] / sum));
    }
    __syncwarp();
    if (lane < hd) {
      float o = 0.f;
      for (int j = 0; j < L; ++j) o += p[j] * Vs[j][lane];
      att[((size_t)w * L + i) * C + h * hd + lane] = __float2bfloat16(o);
    }
    __syncwarp();  // p is rewritten by the next row
  }
}

cudaError_t window_attention(const bf16* qkv, const float* bias,
                             const float* mask, int n_win, bf16* att, int N,
                             int L, int C, int H, cudaStream_t st) {
  const int hd = C / H;
  if (N < 1 || L < 1 || L > kWinMaxL || H < 1 || hd * H != C || hd % 8 ||
      hd > kWinMaxHd || (mask && n_win < 1) || H > 65535)
    return cudaErrorInvalidValue;
  window_attention_kernel<<<dim3(N, H), kWinThreads, 0, st>>>(
      qkv, C, bias, mask, n_win, att, L, hd, 1.f / sqrtf((float)hd));
  return cudaGetLastError();
}

// The block's limits: C and F multiples of 32 (the GEMMs take 16-byte
// rows), and rows to work on.
bool gemm_shapes_ok(int M, int C, int F) {
  return C % 32 == 0 && F % 32 == 0 && M >= 1;
}

}  // namespace

extern "C" {

// out_proj(WindowMHA(x) + bias [+ mask]): x (N, L, C) bf16 -> out, same
// shape. mask is null on unshifted blocks. Scratch (bf16): qkv (N*L, 3C),
// att (N*L, C).
int wt_window_attention(const bf16* x, const bf16* wqkv, const bf16* bqkv,
                        const bf16* wo, const bf16* bo, const float* bias,
                        const float* mask, int n_win, bf16* out, bf16* qkv,
                        bf16* att, int N, int L, int C, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = N * L;
  if (!gemm_shapes_ok(M, C, C)) return (int)cudaErrorInvalidValue;
  WT_CHECK((gemm<bf16, kBias>(x, C, wqkv, 3 * C, bqkv, qkv, 3 * C, nullptr, 0,
                              kNoMap, M, 3 * C, C, kNone, st)));
  WT_CHECK(window_attention(qkv, bias, mask, n_win, att, N, L, C, H, st));
  WT_CHECK((gemm<bf16, kBias>(att, C, wo, C, bo, out, C, nullptr, 0, kNoMap,
                              M, C, C, kNone, st)));
  return 0;
}

// The whole Swin block in the bf16 stream: o = x + out_proj(WindowMHA(LN1 x)
// + bias [+ mask]); out = o + fc2(gelu(fc1(LN2 o))). Scratch (bf16):
// y (N*L, C), qkv (N*L, 3C), att (N*L, C), o (N*L, C), h (N*L, F).
int wt_swin_block(const bf16* x, const float* ln1_s, const float* ln1_b,
                  const bf16* wqkv, const bf16* bqkv, const bf16* wo,
                  const bf16* bo, const float* bias, const float* mask,
                  int n_win, const float* ln2_s, const float* ln2_b,
                  const bf16* wfc, const bf16* bfc, const bf16* wproj,
                  const bf16* bproj, bf16* out, bf16* y, bf16* qkv, bf16* att,
                  bf16* o, bf16* h, int N, int L, int C, int H, int F,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = N * L;
  if (!gemm_shapes_ok(M, C, F)) return (int)cudaErrorInvalidValue;
  WT_CHECK(layernorm(x, 0, ln1_s, ln1_b, y, M, C, st));
  WT_CHECK((gemm<bf16, kBias>(y, C, wqkv, 3 * C, bqkv, qkv, 3 * C, nullptr, 0,
                              kNoMap, M, 3 * C, C, kNone, st)));
  WT_CHECK(window_attention(qkv, bias, mask, n_win, att, N, L, C, H, st));
  WT_CHECK(gemm_residual(att, C, wo, C, bo, o, C, x, C, kNoMap, 0, M, C, C,
                         st));
  WT_CHECK(layernorm(o, 0, ln2_s, ln2_b, y, M, C, st));
  WT_CHECK((gemm<bf16, kBiasAct>(y, C, wfc, F, bfc, h, F, nullptr, 0, kNoMap,
                                 M, F, C, kGelu, st)));
  WT_CHECK(gemm_residual(h, F, wproj, C, bproj, out, C, o, C, kNoMap, 0, M, C,
                         F, st));
  return 0;
}

}  // extern "C"
