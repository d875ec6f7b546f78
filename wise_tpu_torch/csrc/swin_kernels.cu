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
// window_attention_kernel<HD> serves both TPU kernels' attention middles
// (wise_tpu/ops/swin_attention.py _kernel, wise_tpu/ops/swin_block.py
// _kernel): per window and head, logits = QK^T * (1/sqrt(hd)) + bias[h]
// (+ the shift mask of window w mod n_win, the period the TPU kernel's index
// map i % period gives) in f32, an f32 softmax, P rounded to bf16 as
// p.astype(v.dtype) does, PV summed in f32 and written in bf16.
//
// What bounds it: it reads qkv (2 x 3C bytes a token) and the f32 bias and
// mask once, and writes att (2C a token): at stage 0 (4,096 windows x 64
// tokens, C = 96, batch 64) 0.060 ms at 3.35 TB/s, against 6.4 GFLOP that
// the tensor cores do in 0.0065 ms. The old kernel (one CTA of 4 warps per
// (window, head)) took 0.91 ms there on the H100: both products were scalar
// f32 FMAs out of shared memory (a warp a row, 64 sequential FMAs with two
// shared loads each for PV), every CTA read its head's 16 KB bias and, on
// shifted blocks, the window's 16 KB mask (537 MB of L2 reads at stage 0
// shifted against 202 MB of HBM traffic), and a warp walked its 16 rows one
// at a time with two full-warp reductions each. The design here:
//   - mma.sync, not wgmma: a window's products are 64 x 64 x hd and
//     64 x hd x 64, a few instructions a warp; wgmma's depth-16 steps would
//     pad head_dim 24 to 32. Each warp owns 16 query rows. QK^T over 8 key
//     tiles of 8 is m16n8k16 steps plus one m16n8k8 step for a head_dim
//     that is not a multiple of 16 (24 = 16 + 8, 8 = one k8, 16 and 32 k16
//     alone); PV is hd / 8 n-tiles x 4 k-steps of 16 keys. S stays in
//     registers and is P's A fragment, as in attention.cuh; K comes in by
//     ldmatrix, V by ldmatrix.trans.
//   - the softmax in registers in one pass with the reference's p: a row's
//     64 logits are 16 values on each of a quad's 4 lanes, so its max and
//     sum are two quad reductions, and p = bf16(expf(l - m) / sum) is
//     formed with the whole row in hand (no online rescaling). A logit 64
//     or more below its row's max gets p = 0 instead of a subnormal
//     (kWinExpFloor): the division's slow path for those held the shifted
//     blocks at ~4x the unshifted ones' time.
//   - the bias and the mask once per CTA: a CTA (head h) walks a list of
//     windows that share one residue r = w mod n_win (n_win = 1 without a
//     mask). Each warp loads its 16 rows of bias[h] + mask[r], pre-summed in
//     f32, as a 32-register fragment once and keeps it for the walk; keys
//     >= L are -inf there. Pre-summing differs from the reference's
//     (l + bias) + mask only where the mask is nonzero (-100 on Swin's
//     shifted blocks, where p is ~e^-100 either way), and equals it on
//     unshifted blocks. The logit is __fmul_rn(s, scale) + bm: no FMA
//     contraction, the reference's two roundings.
//   - the loads: Q, K and V of head h of the next window go by 16-byte
//     cp.async into a second shared stage while the current window
//     computes (each row piece is head_dim x 2 bytes at row stride 3C x 2);
//     rows >= L are zero-filled. Shared rows are head_dim bf16 where
//     head_dim / 8 is odd (48 bytes at head_dim 24: the 8 rows of an
//     ldmatrix fall in 8 distinct 16-byte bank groups) and padded by 8 where
//     it is even (16, 32). The output goes through the warp's own rows of
//     the dead Q stage and out in 16-byte pieces.
//   - the grid: the head fastest (the H CTAs of one window list run
//     together, so a 32-byte sector two heads' pieces share comes from HBM
//     once), then the residue, then the chunk of the residue's list. The
//     lists are cut into as many chunks as fill the card's resident CTA
//     slots (SMs x CTAs per SM, from the occupancy API), at least one.
// Ragged L (1 to 64): keys >= L are -inf in the fragment and zero rows of
// K and V, query rows >= L are not stored, a warp whose rows are all >= L
// only loads.
//
// What bounds the block on the H100: at HTSAT's widths (C = 96 ... 768) the
// GEMMs are narrow and the window batch large (262,144 rows at stage 0 and
// batch 64). The chain moves ~52 bytes per token and channel through device
// memory (LN outputs, qkv, attention out, residual, the 4C MLP hidden, each
// written and read in bf16) against 24 C FLOPs, ~0.46 C FLOP per byte: under
// the card's ~295 bf16 FLOP per byte at C <= 384 (stages 0-2 are
// bandwidth-bound), near it at C = 768. The chain stays one launch per
// step, intermediates in device memory; fusing LN into the GEMM's operand
// load and the attention into the qkv GEMM is later work.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after each launch.

#include "mma.cuh"  // mma.sync and ldmatrix fragments (includes common.cuh)

namespace {

constexpr int kWinMaxL = 64;                 // tokens per window (window 8)
constexpr int kWinWarps = kWinMaxL / 16;     // a warp per 16 query rows
constexpr int kWinThreads = 32 * kWinWarps;
// exp(d) for d <= -64 (under 2^-92) is taken as 0, and its p is 0: the
// quotient of such a value (or of 0) by a row sum (>= 1: the max's own
// term) sends the IEEE division to its slow path, and the shift mask's -100
// puts many logits of a shifted block there. The row sum is unchanged bit
// for bit (the dropped terms are under half an ulp of 1), and so is every p
// above 2^-92.
constexpr float kWinExpFloor = -64.f;

// a shared row of q, k or v: head_dim bf16, padded by 8 where head_dim / 8
// is even, so that the 8 rows an ldmatrix reads fall in 8 distinct 16-byte
// bank groups
template <int HD>
__host__ __device__ constexpr int win_ld() {
  return (HD / 8) % 2 ? HD : HD + 8;
}

// qkv (N * L, 3C) bf16 rows [q | k | v]; bias (H, L, L) f32; mask
// (n_win, L, L) f32 or null; att (N * L, C) bf16. CTA blockIdx.x = h +
// H * (r + periods * c) (periods = n_win with a mask, else 1) computes head
// h of windows r + periods * (c * chunk + i), i < chunk, of its residue's
// N / periods.
template <int HD>
__global__ void __launch_bounds__(kWinThreads, 4)
window_attention_kernel(const bf16* __restrict__ qkv, int C,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, int periods,
                        bf16* __restrict__ att, int N, int L, int H,
                        int chunk, float scale) {
  // 8-column pieces of a head's row: 16-byte copies, and PV's n-tiles
  constexpr int LD = win_ld<HD>(), kChunks = HD / 8;
  constexpr int kK16 = HD / 16, kTail = HD % 16;  // k16 steps, a k8 step
  constexpr int kPart = kWinMaxL * LD;  // q, k or v of a window
  __shared__ __align__(128) bf16 smem[2 * 3 * kPart];

  const int h = blockIdx.x % H, list = blockIdx.x / H;
  const int r = list % periods, first = (list / periods) * chunk;
  const int count = min(chunk, N / periods - first);
  if (count <= 0) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int row0 = warp * 16;             // the warp's first query row
  const bool live = row0 < L;
  const size_t ld = 3 * (size_t)C;

  // q, k, v of head h of the list's window i into stage s; rows >= L zero
  auto load = [&](int i, int s) {
    const size_t w = r + (size_t)periods * (first + i);
    const bf16* src = qkv + w * L * ld + h * HD;
    bf16* dst = smem + s * 3 * kPart;
    for (int e = tid; e < 3 * kWinMaxL * kChunks; e += kWinThreads) {
      const int part = e / (kWinMaxL * kChunks);
      const int row = e / kChunks % kWinMaxL, col = e % kChunks * 8;
      const bool ok = row < L;
      cp_async16(dst + part * kPart + row * LD + col,
                 src + (ok ? row : 0) * ld + part * C + col, ok);
    }
  };
  load(0, 0);
  cp_async_commit();

  // bias[h] + mask[r] of the warp's rows, once for the walk: element e of
  // n-tile n is row row0 + g + 8 (e / 2), key 8 n + 2 t + e % 2; keys >= L
  // -inf, rows >= L (never stored) 0
  float bm[8][4];
  {
    const float* bh = bias + (size_t)h * L * L;
    const float* mr = mask ? mask + (size_t)r * L * L : nullptr;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + g + (e >> 1) * 8, j = n * 8 + 2 * t + (e & 1);
        float v = j < L ? 0.f : -INFINITY;
        if (j < L && i < L) {
          v = bh[i * L + j];
          if (mr) v += mr[i * L + j];
        }
        bm[n][e] = v;
      }
  }

  for (int i = 0; i < count; ++i) {
    cp_async_wait<0>();  // window i landed ...
    __syncthreads();     // ... for every thread; every warp is done with the
                         // stage the next copy overwrites
    if (i + 1 < count) load(i + 1, (i + 1) & 1);
    cp_async_commit();
    if (!live) continue;
    bf16* qs = smem + (i & 1) * 3 * kPart;
    const bf16* ks = qs + kPart;
    const bf16* vs = ks + kPart;

    // S = Q K^T: the warp's Q fragments, then 8 n-tiles of 8 keys
    unsigned qa[kK16 ? kK16 : 1][4], qt[2];
#pragma unroll
    for (int st = 0; st < kK16; ++st)
      ldmatrix_x4(qa[st], qs + (row0 + (lane & 15)) * LD + st * 16 +
                              (lane >> 4) * 8);
    if (kTail) ldmatrix_x2(qt, qs + (row0 + (lane & 15)) * LD + kK16 * 16);
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int st = 0; st < kK16; ++st) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // one ldmatrix.x4 feeds two n-tiles
        unsigned bk[4];
        ldmatrix_x4(bk, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            st * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[st], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa[st], bk[2], bk[3]);
      }
    }
    if (kTail) {
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {  // one ldmatrix.x4 feeds four n-tiles
        unsigned bk[4];
        ldmatrix_x4(bk, ks + (kh * 32 + lane) * LD + kK16 * 16);
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_bf16_k8(s[4 * kh + q], qt, bk[q]);
      }
    }

    // logits, the rows' max and sum (two quad reductions), p = bf16(exp(l
    // - m) / sum) as the reference rounds it; a logit kWinExpFloor or more
    // below its row's max (the shift mask's -100) gets p = 0
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __fmul_rn(s[n][e], scale) + bm[n][e];
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = s[n][e] - mx[e >> 1];  // -inf on ragged keys
        const float ex = expf(fmaxf(d, kWinExpFloor));  // no branch
        s[n][e] = d > kWinExpFloor ? ex : 0.f;
        sum[e >> 1] += s[n][e];
      }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    // a dropped term divides a stand-in of 2^-100 and is set to 0 after:
    // the division then never leaves its fast path
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float q = fmaxf(s[n][e], 0x1p-100f) / sum[e >> 1];
        s[n][e] = s[n][e] > 0.f ? q : 0.f;
      }

    // O = P V: n-tiles 2 kk and 2 kk + 1 of S are the A fragment of key
    // slice kk; one ldmatrix.x4.trans of V feeds two 8-column n-tiles of O,
    // an ldmatrix.x2.trans the last one of an odd count
    float o[kChunks][4];
#pragma unroll
    for (int n = 0; n < kChunks; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kWinMaxL / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kChunks / 2; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
      if (kChunks % 2) {
        unsigned bv[2];
        ldmatrix_x2_trans(bv, vs + (kk * 16 + (lane & 15)) * LD +
                                  (kChunks - 1) * 8);
        mma_bf16(o[kChunks - 1], pa, bv[0], bv[1]);
      }
    }

    // O through the warp's own 16 rows of the dead Q stage (no other warp
    // reads them), then 16-byte stores of the rows < L
    bf16* os = qs + row0 * LD;
#pragma unroll
    for (int n = 0; n < kChunks; ++n) {
      *reinterpret_cast<unsigned*>(os + g * LD + n * 8 + 2 * t) =
          pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<unsigned*>(os + (g + 8) * LD + n * 8 + 2 * t) =
          pack_bf16(o[n][2], o[n][3]);
    }
    __syncwarp();
    const size_t w = r + (size_t)periods * (first + i);
    for (int e = lane; e < 16 * kChunks; e += 32) {
      const int rr = e / kChunks, col = e % kChunks * 8;
      if (row0 + rr < L)
        *reinterpret_cast<uint4*>(att + (w * L + row0 + rr) * C + h * HD +
                                  col) =
            *reinterpret_cast<const uint4*>(os + rr * LD + col);
    }
  }
}

template <int HD>
cudaError_t launch_window_attention(const bf16* qkv, const float* bias,
                                    const float* mask, int periods, bf16* att,
                                    int N, int L, int C, int H,
                                    cudaStream_t st) {
  // resident CTAs a card holds: SMs x CTAs an SM (registers and shared
  // memory decide the second; it is the same on every call)
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_attention_kernel<HD>, kWinThreads, 0);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // each of the H x periods lists in as many chunks as fill those slots
  const int per_residue = N / periods;
  const long long lists = (long long)H * periods;
  const long long fit = (long long)sms * per_sm / lists;
  int chunks = fit < 1 ? 1 : fit < per_residue ? (int)fit : per_residue;
  const int chunk = (per_residue + chunks - 1) / chunks;
  chunks = (per_residue + chunk - 1) / chunk;
  window_attention_kernel<HD><<<(unsigned)(lists * chunks), kWinThreads, 0,
                                st>>>(qkv, C, bias, mask, periods, att, N, L,
                                      H, chunk, 1.f / sqrtf((float)HD));
  return cudaGetLastError();
}

cudaError_t window_attention(const bf16* qkv, const float* bias,
                             const float* mask, int n_win, bf16* att, int N,
                             int L, int C, int H, cudaStream_t st) {
  if (N < 1 || L < 1 || L > kWinMaxL || H < 1 || C % H ||
      (long long)N * H > INT_MAX || (mask && (n_win < 1 || N % n_win)))
    return cudaErrorInvalidValue;
  const int periods = mask ? n_win : 1;
  switch (C / H) {
    case 8:
      return launch_window_attention<8>(qkv, bias, mask, periods, att, N, L,
                                        C, H, st);
    case 16:
      return launch_window_attention<16>(qkv, bias, mask, periods, att, N, L,
                                         C, H, st);
    case 24:
      return launch_window_attention<24>(qkv, bias, mask, periods, att, N, L,
                                         C, H, st);
    case 32:
      return launch_window_attention<32>(qkv, bias, mask, periods, att, N, L,
                                         C, H, st);
    default:
      return cudaErrorInvalidValue;
  }
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
