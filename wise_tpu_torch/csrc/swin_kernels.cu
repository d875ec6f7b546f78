// Swin-block kernels for Hopper (sm_90a): the windowed-attention blocks of
// CLAP's HTSAT audio tower.
//
// Replaces the Pallas TPU kernels:
//   wt_window_attention  <- wise_tpu/ops/swin_attention.py fused_window_attention
//   wt_swin_block        <- wise_tpu/ops/swin_block.py     fused_swin_block
//
// Both work on x (rows, C) bf16 in window layout: N = batch x windows
// windows of L = window^2 tokens (64 for HTSAT's window 8), heads of
// head_dim C / H (24 at every HTSAT stage). wt_swin_block also takes a
// token map (below), under which x and out are spatial rows and the shift's
// roll and the window partition are read through an index.
//
// Two routes, picked by C alone (never by a failed build or launch):
//   C <= kSwinFusedMaxC (384: HTSAT's stages 0-2), two kernels a block:
//     swin_attn_kernel<HD>  o = x + out_proj(WindowMHA(LN1 x) + bias [+ mask])
//     swin_mlp_kernel       out = o + fc2(gelu(fc1(LN2 o)))
//   and wt_window_attention is swin_attn_kernel alone, LN and residual off;
//   C > 384 (stage 3, C 768): the chain of earlier PRs, which keeps its
//     intermediates in device memory: LN1 -> qkv GEMM -> window attention ->
//     out-proj GEMM + residual -> LN2 -> fc1 GEMM + GELU -> fc2 GEMM +
//     residual (wt_window_attention: qkv GEMM -> window attention ->
//     out-proj GEMM). Why: kernel A holds a window's y and att (2 x 64 rows
//     of C + 8 bf16: 198,656 B at C 768), its q, k and v (9,216 B), three
//     weight pieces of C x 24 bf16 (110,592 B), the bias + mask table and
//     LN1's parameters (24,576 B): 343,040 B against the 232,448 a block
//     may use (186,368 at C 384); and kernel B holds y2,
//     Wfc's chunk and Wproj's chunk (3 x 64 x C bf16: 294,912 B at C 768,
//     147,456 at C 384). Stage 3 is 2 of HTSAT's 12 blocks.
// Each entry adds one, in the caller's host array ``launched``
// (SwinKernel), for each kernel it launched, where it launched it.
//
// What bounds the block on the H100: 24 M C^2 + 256 M C operations
// (qkv 6, out-proj 2, fc1 + fc2 16 M C^2; the attention 4 M L C) at
// 989 TFLOP/s against the bytes each input and output take once: x and out
// (4 M C), the weights (24 C^2) and the f32 bias and mask; at stage 0
// (4,096 windows x 64 x 96, batch 64) 0.0651 ms by operations against
// ~0.030 by bytes, the other stages by operations too (0.0619, 0.0603 and
// 0.0594 ms at stages 1-3: M C^2 is the same at each). The chain moved ~52
// bytes a token and channel through device memory (y, qkv, att, o, h, each
// written and read in bf16); the two kernels move ~8: x in, o out and in
// (kernel A to kernel B), out. What the design does about the rest:
//   - no spatial copies: the map gives, for window-layout row r of an
//     image, its spatial row (the roll by -shift, then the window
//     partition, applied to an arange), and the kernel adds the image's
//     base. Kernel A reads x's rows and writes o's rows through it; the
//     reverse partition and the roll back are the inverse permutation, so
//     o lands in spatial order, and kernel B, which is per token, runs on
//     spatial rows with no map at all.
//   - kernel A's products on mma.sync m16n8k16 tiles (bf16 in, f32 sums),
//     A from shared memory by ldmatrix, B (the (K, N) weights, as stored) by
//     ldmatrix.trans, a warp a 16-row slab: a head's N is 3 x 24 and its
//     attention 64 x 64 x 24, which mma.sync takes with no padding; kernel
//     B's (16 M C^2 of the block's 24) on wgmma, the card's full rate: a
//     warpgroup a 64-row tile, the weights in 128-byte-swizzled boxes of 64
//     columns (gemm_kernel's layout), fc1 and fc2 each with both operands
//     in shared memory (h_c through a swizzled tile of its own).
//   - weights from L2 in pieces: every CTA reads the same weights, so they
//     stream by cp.async from L2 (kernel A: a ring of kSwinRing = 3 slots,
//     two pieces loading under the current piece's products; kernel B:
//     Wfc's chunk under fc2, Wproj's under fc1); HBM sees them about once.
// Rounding is the chain's (and the TPU kernel's): y, q / k / v, p, att, o,
// h and out in bf16; LayerNorm (layernorm_kernel's arithmetic), softmax,
// GELU (erf) and every sum in f32; o = bf16(x + bf16(att Wo + bo)), out =
// bf16(o + bf16(h Wproj + bproj)).
//
// Kernel A, swin_attn_kernel<HD> (the TPU kernel's whole attention half):
// a CTA of 4 warps walks a list of windows of one residue r of the shift
// mask (w mod n_win; one residue without a mask), the lists cut into as
// many chunks as fill the card's resident CTAs, G windows at a time (G <=
// 4: the most CTAs an SM first, then the largest G shared memory allows). A
// warp owns query rows 16 w .. 16 w + 15 of every window. For each group:
//   - x's rows through the map by cp.async (rows >= L zero), LN1 in place
//     (two threads a row), y kept in shared memory as bf16;
//   - for each head h: the table bias[h] + mask[r] (64 x 64 f32, pre-summed,
//     keys >= L at -inf), read once by the whole CTA with coalesced loads
//     (a fragment read a warp a head cost more than the attention, PR 15's
//     bench); then q, k and v of every window, each from its own weight
//     piece (C x hd of Wqkv, the next piece loading meanwhile): bf16(y W +
//     b) into the window's q, k, v tiles (a ring of three slots: two pieces
//     load ahead); then window_attention_kernel's
//     attention window by window with no barrier between (QK^T k16 + k8 at
//     head_dim 24, the softmax in registers with the table's entry added to
//     each logit and kWinExpFloor, PV), att's columns of head h rounded into
//     shared memory;
//   - the out-projection in pieces of hd columns of Wo: bf16(att Wo + bo)
//     over y's dead rows, then out = bf16(x + that) (or that alone), 16
//     bytes a thread through the map.
// Its weight pieces stream once a group (8 C^2 bytes) and the table once a
// group and head.
//
// Kernel B, swin_mlp_kernel<WGS, NP, TAIL> (the MLP half, 16 M C^2 of the
// block's 24): a CTA owns 64 token rows, one warpgroup (C <= 192) or two
// that split fc2's columns (C <= 384; 96 accumulators a thread at most).
// o's rows in by cp.async into a 128-byte-swizzled K-major tile, LN2 in
// place (four rows a warp at a time); then F in chunks of 64 columns: fc1
// = y2 Wfc_c on wgmma (A and B in shared memory; with two warpgroups, 32
// of the 64 columns each) while Wproj_c loads; h_c = bf16(gelu(fc1 +
// bfc_c)) written into a swizzled K-major tile of its own; acc += h_c
// Wproj_c on wgmma, both operands in shared memory, while Wfc_{c+1}
// loads. h never reaches device memory. Epilogue: out = bf16(o + bf16(acc
// + bproj)), through the dead y2 tile and out in 16-byte pieces.
// The weights are read once a 64-row tile (16 C^2 bytes), from L2.
//
// window_attention_kernel<HD> (PR 14) serves the chain at C > 384:
// per window and head, logits = QK^T * (1/sqrt(hd)) + bias[h] (+ the shift
// mask of window w mod n_win, the period the TPU kernel's index map i %
// period gives) in f32, an f32 softmax, P rounded to bf16 as
// p.astype(v.dtype) does, PV summed in f32 and written in bf16. It reads
// qkv (2 x 3C bytes a token) and the f32 bias and mask once, and writes att
// (2C a token): a CTA of 4 warps a (head, residue of the shift mask, chunk
// of the residue's windows), the design of swin_attn_kernel's middle:
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
// Ragged L (1 to 64), in both attention kernels: keys >= L are -inf in the
// fragment, query rows >= L are not stored.
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

// The kernels the C entries count: the indices of their ``launched`` array
// (ops/swin_attention.py KERNELS holds the names in this order). An entry
// adds one to a kernel's count where it launched that kernel.
enum SwinKernel {
  kCountSwinAttn,
  kCountSwinMlp,
  kCountWindowAttention,
  kCountGemm,
  kCountLayerNorm,
  kCountKinds
};

template <int HD>
cudaError_t launch_window_attention(const bf16* qkv, const float* bias,
                                    const float* mask, int periods, bf16* att,
                                    int N, int L, int C, int H,
                                    cudaStream_t st, int* launched) {
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
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[kCountWindowAttention];
  return err;
}

cudaError_t window_attention(const bf16* qkv, const float* bias,
                             const float* mask, int n_win, bf16* att, int N,
                             int L, int C, int H, cudaStream_t st,
                             int* launched) {
  if (N < 1 || L < 1 || L > kWinMaxL || H < 1 || C % H ||
      (long long)N * H > INT_MAX || (mask && (n_win < 1 || N % n_win)))
    return cudaErrorInvalidValue;
  const int periods = mask ? n_win : 1;
  switch (C / H) {
    case 8:
      return launch_window_attention<8>(qkv, bias, mask, periods, att, N, L,
                                        C, H, st, launched);
    case 16:
      return launch_window_attention<16>(qkv, bias, mask, periods, att, N, L,
                                         C, H, st, launched);
    case 24:
      return launch_window_attention<24>(qkv, bias, mask, periods, att, N, L,
                                         C, H, st, launched);
    case 32:
      return launch_window_attention<32>(qkv, bias, mask, periods, att, N, L,
                                         C, H, st, launched);
    default:
      return cudaErrorInvalidValue;
  }
}


// The block's limits: C and F multiples of 32 (16-byte rows for the GEMMs
// and the cp.async pieces, whole k16 steps), and rows to work on.
bool gemm_shapes_ok(int M, int C, int F) {
  return C % 32 == 0 && F % 32 == 0 && M >= 1;
}

// ---------------------------------------------------------------------------
// The block in two kernels, at C <= kSwinFusedMaxC
// ---------------------------------------------------------------------------

constexpr int kSwinFusedMaxC = 384;   // wider blocks run the chain
constexpr int kSwinAttnThreads = 128; // kernel A: a warp per 16 rows
constexpr int kSwinMaxGroup = 4;      // windows a kernel-A CTA holds at once
constexpr int kSwinRing = 3;          // kernel A's weight slots: 2 ahead
constexpr int kSmemMax = 232448;      // dynamic shared memory a block may use

// a shared row of n bf16 (n a multiple of 8) padded to an odd count of
// 16-byte pieces: the 8 rows an ldmatrix reads fall in 8 distinct 16-byte
// bank groups
__host__ __device__ constexpr int odd_ld(int n) { return ((n / 8) | 1) * 8; }

// the bias + mask table's row (f32): a warp's 8-byte reads of 16 rows fall
// in distinct banks a half-warp
constexpr int kTabLd = 72;

// the row of window-layout token i of window w in x and out: the row itself
// without a map; with one, row map[t mod map_len] of image t / map_len
__device__ __forceinline__ size_t token_row(const int* map, int map_len,
                                            size_t w, int L, int i) {
  const size_t t = w * L + i;
  if (!map) return t;
  const size_t img = t / map_len;
  return img * map_len + map[t - img * map_len];
}

// 8 bf16 of a 16-byte piece: bf16(r + inc) in f32, the chain's residual
// epilogue (out = bf16(r + f32(bf16 increment)))
__device__ __forceinline__ uint4 add_bf16x8(uint4 r, uint4 inc) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&r);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&inc);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(a[i]), y = __bfloat1622float2(b[i]);
    o[i] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
  }
  return out;
}

// LayerNorm in place of ``rows`` shared bf16 rows, TPR adjacent threads a
// row, row m's 16-byte piece j at byte off(m, j) of base: each thread sums
// its pieces (j = its lane in the row, + TPR, ...) in f32, the row's TPR
// partial sums meet by shuffles, var = E[x^2] - E[x]^2 clamped at 0, and
// y = bf16((x - mean) * (rsqrt(var + eps) * s) + b) (layernorm_kernel's
// formula; its sums run in another order). Every thread of the block calls
// it.
template <int TPR, typename Off>
__device__ __forceinline__ void layernorm_tile(unsigned char* base, Off off,
                                               int rows, int C,
                                               const float* s,
                                               const float* b, int tid,
                                               int threads) {
  const int per = C / 8;
  for (int m0 = 0; m0 < rows; m0 += threads / TPR) {
    const int m = m0 + tid / TPR, sub = tid % TPR;
    const bool ok = m < rows;
    float sum = 0.f, sq = 0.f;
    for (int j = sub; ok && j < per; j += TPR) {
      const uint4 v = *reinterpret_cast<const uint4*>(base + off(m, j));
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(x[i]);
        sum += f.x;
        sum += f.y;
        sq += f.x * f.x;
        sq += f.y * f.y;
      }
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    if (!ok) continue;
    const float mean = sum / C;
    const float var = fmaxf(sq / C - mean * mean, 0.f);
    const float rs = rsqrtf(var + kEps);
    for (int j = sub; j < per; j += TPR) {
      uint4 v = *reinterpret_cast<const uint4*>(base + off(m, j));
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 8 * j + 2 * i;
        const float2 f = __bfloat1622float2(x[i]);
        x[i] = __floats2bfloat162_rn((f.x - mean) * (rs * s[k]) + b[k],
                                     (f.y - mean) * (rs * s[k + 1]) +
                                         b[k + 1]);
      }
      *reinterpret_cast<uint4*>(base + off(m, j)) = v;
    }
  }
}

// acc[n] (16 x 8 f32, n < nt <= NT) += A B: A the warp's 16 rows of a shared
// bf16 matrix at a (row stride lda, columns [0, K)), B a shared bf16 (K, .)
// matrix at b (row stride ldb, columns 8n .. 8n + 7), K a multiple of 16.
// A by ldmatrix, B by ldmatrix.trans (two n-tiles an x4, an odd last one an
// x2), m16n8k16 steps.
template <int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const bf16* a,
                                         int lda, const bf16* b, int ldb,
                                         int K, int nt, int lane) {
  for (int k = 0; k < K; k += 16) {
    unsigned af[4];
    ldmatrix_x4(af, a + (lane & 15) * lda + k + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (n + 1 < NT && n + 1 < nt) {
        unsigned bf[4];
        ldmatrix_x4_trans(bf, b + (k + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      ldb + n * 8 + (lane >> 4) * 8);
        mma_bf16(acc[n], af, bf[0], bf[1]);
        mma_bf16(acc[n + 1], af, bf[2], bf[3]);
      } else if (n < nt) {
        unsigned bf[2];
        ldmatrix_x2_trans(bf, b + (k + (lane & 15)) * ldb + n * 8);
        mma_bf16(acc[n], af, bf[0], bf[1]);
      }
    }
  }
}

struct SwinAttnArgs {
  const bf16* x;     // (rows, C): window layout, or spatial rows under map
  const int* map;    // (map_len,) window-layout row -> spatial row, or null
  int map_len;       // tokens an image under the map
  const float* ln_s; // LN1 scale and bias, or null: no LayerNorm
  const float* ln_b;
  const bf16* wqkv;  // (C, 3C) [q | k | v]
  const bf16* bqkv;
  const bf16* wo;    // (C, C)
  const bf16* bo;
  const float* bias; // (H, L, L)
  const float* mask; // (periods, L, L) or null
  int periods;       // the mask's windows, 1 without one
  bf16* out;         // x's layout and rows
  int residual;      // out = x + attention, or the attention alone
  int N, L, C, H;
  int chunk;         // windows a CTA's list
  int group;         // windows a CTA holds at once
  float scale;       // 1 / sqrt(head_dim)
};

// Kernel A. CTA blockIdx.x = r + periods * c walks windows r + periods *
// (c * chunk + i), i < chunk, of its residue's N / periods, in groups of G.
// Shared memory: per window (bf16) 64 x YLD of y (x, then LN1 x, then the
// out-proj increment), 64 x YLD of att, and q, k, v of the head in hand
// (64 x KLD each); kSwinRing weight slots of C x KLD bf16 (a head's q, k or
// v columns of Wqkv, or hd columns of Wo); the head's bias + mask
// table (64 x kTabLd f32); LN1's scale and bias (f32).
template <int HD>
__global__ void __launch_bounds__(kSwinAttnThreads, 3)
swin_attn_kernel(const SwinAttnArgs p) {
  constexpr int KLD = win_ld<HD>();
  constexpr int kChunks = HD / 8, kK16 = HD / 16, kTail = HD % 16;
  constexpr int kPart = kWinMaxL * KLD;  // q, k or v of a window
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = p.C, H = p.H, L = p.L, G = p.group, YLD = odd_ld(C);
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);
  bf16* att = ys + G * kWinMaxL * YLD;
  bf16* qkv = att + G * kWinMaxL * YLD;         // G x (q, k, v)
  bf16* slots = qkv + G * 3 * kPart;
  float* tab = reinterpret_cast<float*>(slots + kSwinRing * C * KLD);
  float* lns = tab + kWinMaxL * kTabLd;         // 2 x C

  const int r = blockIdx.x % p.periods;
  const int first = (blockIdx.x / p.periods) * p.chunk;
  const int count = min(p.chunk, p.N / p.periods - first);
  if (count <= 0) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int row0 = warp * 16;             // the warp's first row of a window
  const int per_row = C / 8;              // 16-byte pieces of a row
  const int P = 4 * H;                    // weight pieces a group
  const int groups = (count + G - 1) / G;
  const int total = groups * P;
  auto window = [&](int i) {
    return (size_t)r + (size_t)p.periods * (first + i);
  };

  // weight piece q into slot q mod kSwinRing, a commit group of its own
  // (an empty one past the last): q mod P < 3 H part (q mod P) mod 3 (q, k
  // or v) of head (q mod P) / 3, C x hd of Wqkv; else hd columns of Wo
  auto load_piece = [&](int q) {
    if (q < total) {
      const int kind = q % P;
      bf16* dst = slots + (q % kSwinRing) * C * KLD;
      const bf16* src = kind < 3 * H
                            ? p.wqkv + (kind % 3) * C + (kind / 3) * HD
                            : p.wo + (kind - 3 * H) * HD;
      const int ld = kind < 3 * H ? 3 * C : C;
      for (int e = tid; e < C * kChunks; e += kSwinAttnThreads) {
        const int row = e / kChunks, c = e % kChunks;
        cp_async16(dst + row * KLD + c * 8, src + (size_t)row * ld + c * 8,
                   true);
      }
    }
    cp_async_commit();
  };
  // piece q landed (kSwinRing - 2 newer groups may still fly) and every
  // thread is done with piece q - 1, whose slot the next load takes
  auto next_piece = [&](int q) {
    cp_async_wait<kSwinRing - 2>();
    __syncthreads();
    load_piece(q + kSwinRing - 1);
    return slots + (q % kSwinRing) * C * KLD;
  };

  int q = 0;  // the weight piece in hand
  for (int i = 0; i < kSwinRing - 1; ++i) load_piece(i);
  if (p.ln_s)
    for (int i = tid; i < C; i += kSwinAttnThreads) {
      lns[i] = p.ln_s[i];
      lns[C + i] = p.ln_b[i];
    }
  for (int gi = 0; gi < groups; ++gi) {
    const int g0 = gi * G, gn = min(G, count - g0);
    // x's rows through the map; rows >= L zero
    for (int j = 0; j < gn; ++j) {
      const size_t w = window(g0 + j);
      bf16* dst = ys + j * kWinMaxL * YLD;
      for (int e = tid; e < kWinMaxL * per_row; e += kSwinAttnThreads) {
        const int row = e / per_row, col = e % per_row * 8;
        const bool ok = row < L;
        const size_t src = ok ? token_row(p.map, p.map_len, w, L, row) : 0;
        cp_async16(dst + row * YLD + col, p.x + src * C + col, ok);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (p.ln_s) {
      layernorm_tile<2>(
          reinterpret_cast<unsigned char*>(ys),
          [&](int m, int j) { return (m * YLD + 8 * j) * 2; }, gn * kWinMaxL,
          C, lns, lns + C, tid, kSwinAttnThreads);
      __syncthreads();
    }

    for (int h = 0; h < H; ++h) {
      // bias[h] + mask[r] as a 64 x 64 table, pre-summed in f32 (keys >= L
      // -inf, rows >= L 0): one coalesced read a head and group, every load
      // issued before the first store (the stores may not pass them)
      {
        const float* __restrict__ bh = p.bias + (size_t)h * L * L;
        const float* __restrict__ mr =
            p.mask ? p.mask + (size_t)r * L * L : nullptr;
        constexpr int kPer = kWinMaxL * kWinMaxL / kSwinAttnThreads / 4;
        float4 v[kPer];
        if (L == kWinMaxL) {  // whole rows of 16-byte pieces
#pragma unroll
          for (int u = 0; u < kPer; ++u)
            v[u] = __ldg(reinterpret_cast<const float4*>(bh) + tid +
                         u * kSwinAttnThreads);
          if (mr) {
#pragma unroll
            for (int u = 0; u < kPer; ++u) {
              const float4 m = __ldg(reinterpret_cast<const float4*>(mr) +
                                     tid + u * kSwinAttnThreads);
              v[u].x += m.x, v[u].y += m.y, v[u].z += m.z, v[u].w += m.w;
            }
          }
        } else {
          auto entry = [&](int i, int j) {
            float x = j < L ? 0.f : -INFINITY;
            if (i < L && j < L) {
              x = __ldg(bh + i * L + j);
              if (mr) x += __ldg(mr + i * L + j);
            }
            return x;
          };
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int e = 4 * (tid + u * kSwinAttnThreads);
            const int i = e >> 6, j = e & 63;
            v[u] = make_float4(entry(i, j), entry(i, j + 1), entry(i, j + 2),
                               entry(i, j + 3));
          }
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int e = 4 * (tid + u * kSwinAttnThreads);
          *reinterpret_cast<float4*>(tab + (e >> 6) * kTabLd + (e & 63)) =
              v[u];
        }
      }
      // q, k, v of head h for every window, a part (and a piece) at a time
      for (int part = 0; part < 3; ++part, ++q) {
        const bf16* wq = next_piece(q);
        for (int j = 0; j < gn; ++j) {
          float acc[kChunks][4];
#pragma unroll
          for (int n = 0; n < kChunks; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
          warp_mma<kChunks>(acc, ys + (j * kWinMaxL + row0) * YLD, YLD, wq,
                            KLD, C, kChunks, lane);
          bf16* dst = qkv + (j * 3 + part) * kPart + row0 * KLD + 2 * t;
#pragma unroll
          for (int n = 0; n < kChunks; ++n) {
            // the bias at the warp's columns of the n-tile (from L1)
            const float2 b = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    p.bqkv + part * C + h * HD + n * 8 + 2 * t));
            *reinterpret_cast<unsigned*>(dst + g * KLD + n * 8) =
                pack_bf16(acc[n][0] + b.x, acc[n][1] + b.y);
            *reinterpret_cast<unsigned*>(dst + (g + 8) * KLD + n * 8) =
                pack_bf16(acc[n][2] + b.x, acc[n][3] + b.y);
          }
        }
      }
      __syncthreads();  // every window's q, k, v

      // the attention of head h, window by window (the windows' q, k, v
      // apart: no barrier between them)
      for (int j = 0; j < gn; ++j) {
        const bf16* qs = qkv + j * 3 * kPart;
        const bf16* ks = qs + kPart;
        const bf16* vs = ks + kPart;
        // S = Q K^T: the warp's Q fragments, then 8 n-tiles of 8 keys
        unsigned qa[kK16 ? kK16 : 1][4], qt[2];
#pragma unroll
        for (int st = 0; st < kK16; ++st)
          ldmatrix_x4(qa[st], qs + (row0 + (lane & 15)) * KLD + st * 16 +
                                  (lane >> 4) * 8);
        if (kTail)
          ldmatrix_x2(qt, qs + (row0 + (lane & 15)) * KLD + kK16 * 16);
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int st = 0; st < kK16; ++st) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            unsigned bk[4];
            ldmatrix_x4(bk, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     KLD + st * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], qa[st], bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qa[st], bk[2], bk[3]);
          }
        }
        if (kTail) {
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            unsigned bk[4];
            ldmatrix_x4(bk, ks + (kh * 32 + lane) * KLD + kK16 * 16);
#pragma unroll
            for (int qq = 0; qq < 4; ++qq)
              mma_bf16_k8(s[4 * kh + qq], qt, bk[qq]);
          }
        }
        // the softmax, window_attention_kernel's, the table's entry added
        // to each logit
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 bm = *reinterpret_cast<const float2*>(
                tab + (row0 + g + 8 * hh) * kTabLd + n * 8 + 2 * t);
            s[n][2 * hh] = __fmul_rn(s[n][2 * hh], p.scale) + bm.x;
            s[n][2 * hh + 1] = __fmul_rn(s[n][2 * hh + 1], p.scale) + bm.y;
            mx[hh] = fmaxf(mx[hh], fmaxf(s[n][2 * hh], s[n][2 * hh + 1]));
          }
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = s[n][e] - mx[e >> 1];
            const float ex = expf(fmaxf(d, kWinExpFloor));
            s[n][e] = d > kWinExpFloor ? ex : 0.f;
            sum[e >> 1] += s[n][e];
          }
        sum[0] = quad_sum(sum[0]);
        sum[1] = quad_sum(sum[1]);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float qv = fmaxf(s[n][e], 0x1p-100f) / sum[e >> 1];
            s[n][e] = s[n][e] > 0.f ? qv : 0.f;
          }
        // O = P V
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
                                        ((lane >> 3) & 1) * 8) * KLD +
                                      dp * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
            mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
          }
          if (kChunks % 2) {
            unsigned bv[2];
            ldmatrix_x2_trans(bv, vs + (kk * 16 + (lane & 15)) * KLD +
                                      (kChunks - 1) * 8);
            mma_bf16(o[kChunks - 1], pa, bv[0], bv[1]);
          }
        }
        // att's columns of head h, rounded
        bf16* at = att + (j * kWinMaxL + row0) * YLD + h * HD + 2 * t;
#pragma unroll
        for (int n = 0; n < kChunks; ++n) {
          *reinterpret_cast<unsigned*>(at + g * YLD + n * 8) =
              pack_bf16(o[n][0], o[n][1]);
          *reinterpret_cast<unsigned*>(at + (g + 8) * YLD + n * 8) =
              pack_bf16(o[n][2], o[n][3]);
        }
      }
      __syncthreads();  // q, k, v and the table free for the next head
    }

    // the out-projection, hd columns a piece: bf16(att Wo + bo) over y's
    // rows (dead since the last head's qkv)
    for (int b = 0; b < H; ++b, ++q) {
      const bf16* wq = next_piece(q);
      const int c0 = b * HD;
      for (int j = 0; j < gn; ++j) {
        float acc[kChunks][4];
#pragma unroll
        for (int n = 0; n < kChunks; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
        warp_mma<kChunks>(acc, att + (j * kWinMaxL + row0) * YLD, YLD, wq,
                          KLD, C, kChunks, lane);
        bf16* dst = ys + (j * kWinMaxL + row0) * YLD + c0 + 2 * t;
#pragma unroll
        for (int n = 0; n < kChunks; ++n) {
          const float2 bo = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.bo + c0 + n * 8 +
                                                       2 * t));
          *reinterpret_cast<unsigned*>(dst + g * YLD + n * 8) =
              pack_bf16(acc[n][0] + bo.x, acc[n][1] + bo.y);
          *reinterpret_cast<unsigned*>(dst + (g + 8) * YLD + n * 8) =
              pack_bf16(acc[n][2] + bo.x, acc[n][3] + bo.y);
        }
      }
    }
    __syncthreads();  // every warp's increment

    // out = x + increment (or the increment), rows < L through the map
    for (int j = 0; j < gn; ++j) {
      const size_t w = window(g0 + j);
      const bf16* src = ys + j * kWinMaxL * YLD;
      for (int e = tid; e < L * per_row; e += kSwinAttnThreads) {
        const int row = e / per_row, col = e % per_row * 8;
        const size_t at = token_row(p.map, p.map_len, w, L, row) * C + col;
        uint4 v = *reinterpret_cast<const uint4*>(src + row * YLD + col);
        if (p.residual)
          v = add_bf16x8(*reinterpret_cast<const uint4*>(p.x + at), v);
        *reinterpret_cast<uint4*>(p.out + at) = v;
      }
    }
    __syncthreads();  // y's rows free for the next group's x
  }
}

template <int HD>
size_t attn_smem_bytes(int C, int G) {
  return sizeof(bf16) * ((size_t)2 * G * kWinMaxL * odd_ld(C) +
                         ((size_t)3 * G * kWinMaxL + kSwinRing * C) *
                             win_ld<HD>()) +
         sizeof(float) * ((size_t)kWinMaxL * kTabLd + 2 * C);
}

template <int HD>
cudaError_t launch_swin_attn(SwinAttnArgs p, cudaStream_t st, int* launched) {
  // the group G and CTAs an SM, per C: the most CTAs an SM (warps to hide
  // the attention's latency), then the largest G (fewer weight and bias
  // reads a window); the same on every call
  static int plan[kSwinFusedMaxC / 32 + 1];
  static PerDevice smem_set;
  cudaError_t err = max_dynamic_smem(smem_set, swin_attn_kernel<HD>,
                                     kSmemMax);
  if (err != cudaSuccess) return err;
  int& cached = plan[p.C / 32];
  if (cached == 0) {
    int best_g = 0, best_per = 0;
    for (int G = 1; G <= kSwinMaxGroup; ++G) {
      const size_t bytes = attn_smem_bytes<HD>(p.C, G);
      if (bytes > (size_t)kSmemMax) break;
      int per = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, swin_attn_kernel<HD>, kSwinAttnThreads, bytes);
      if (err != cudaSuccess) return err;
      if (per >= best_per && per > 0) best_g = G, best_per = per;
    }
    if (best_g == 0) return cudaErrorInvalidValue;
    cached = best_g * 64 + best_per;
  }
  const int G = cached / 64, per_sm = cached % 64;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // each residue's list in as many chunks as fill the resident CTAs
  const int per_residue = p.N / p.periods;
  const long long fit = (long long)sms * per_sm / p.periods;
  int chunks = fit < 1 ? 1 : fit < per_residue ? (int)fit : per_residue;
  p.chunk = (per_residue + chunks - 1) / chunks;
  chunks = (per_residue + p.chunk - 1) / p.chunk;
  p.group = G;
  swin_attn_kernel<HD><<<(unsigned)((long long)p.periods * chunks),
                         kSwinAttnThreads, attn_smem_bytes<HD>(p.C, G), st>>>(
      p);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[kCountSwinAttn];
  return err;
}

// the shapes kernel A takes: windows of 1 to 64 tokens, head_dim 8, 16, 24
// or 32, C <= kSwinFusedMaxC, a mask whose windows divide the batch
bool swin_attn_ok(int N, int L, int C, int H, const float* mask, int n_win) {
  return N >= 1 && L >= 1 && L <= kWinMaxL && H >= 1 && C % H == 0 &&
         C <= kSwinFusedMaxC && (!mask || (n_win >= 1 && N % n_win == 0));
}

cudaError_t swin_attention(const SwinAttnArgs& p, cudaStream_t st,
                           int* launched) {
  switch (p.C / p.H) {
    case 8:
      return launch_swin_attn<8>(p, st, launched);
    case 16:
      return launch_swin_attn<16>(p, st, launched);
    case 24:
      return launch_swin_attn<24>(p, st, launched);
    case 32:
      return launch_swin_attn<32>(p, st, launched);
    default:
      return cudaErrorInvalidValue;
  }
}

// orders this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) before the async proxy's reads of the same bytes (wgmma's
// operands); a barrier after it publishes them to the warpgroups
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma m64n32k16 bf16 -> f32, A (64 x k16, K-major) and B (k16 x 32,
// MN-major) from shared memory under their 128-byte-swizzle descriptors,
// D += A B: gemm_kernel's Wgmma<64> at N = 32
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

constexpr int kMlpRows = 64;        // kernel B: rows a CTA (one m64 tile)
constexpr int kMlpChunk = 64;       // F columns a chunk: one swizzle box
constexpr int kBoxBytes = kGemmBK * kBoxCols * 2;  // 64 x 64 bf16, swizzled

// byte offset of element (m, k) of a K-major operand of ``rows`` rows in
// 128-byte-swizzled boxes of 64 columns (TMA's SWIZZLE_128B layout: the
// 16-byte piece c of row m at piece c ^ (m mod 8))
__device__ __forceinline__ int swz_off(int m, int k, int rows) {
  return (k >> 6) * rows * kSwzRowBytes + m * kSwzRowBytes +
         ((((k & 63) >> 3) ^ (m & 7)) << 4) + ((k & 7) << 1);
}

struct SwinMlpArgs {
  const bf16* o;       // (M, C): the attention half's output
  const float* ln_s;   // LN2
  const float* ln_b;
  const bf16* wfc;     // (C, F)
  const bf16* bfc;
  const bf16* wproj;   // (F, C)
  const bf16* bproj;
  bf16* out;           // (M, C)
  int M, C, F;
  int split;           // fc2 columns of warpgroup 0 (all of C with one)
};

// Kernel B: CTA blockIdx.x owns rows 64 blockIdx.x ... of the M, WGS = one
// warpgroup (C <= 192) or two (wider: warpgroup s the fc2 columns [s split,
// (s + 1) split), and fc1's 32 columns [32 s, 32 s + 32) of each chunk).
// Shared memory, from a 1,024-byte boundary, in 128-byte-swizzled boxes of
// 64 columns (gemm_kernel's TMA layout, written here by cp.async and
// st.shared): y2 (64 x C, K-major: fc1's A, then the increment), Wfc's
// chunk (C x 64, MN-major), Wproj's chunk (64 x C), h_c (64 x 64, K-major:
// fc2's A), then LN2's scale and bias (f32). Per chunk: fc1 = y2 Wfc_c
// while Wproj_c loads; h_c = bf16(gelu(fc1 + bfc_c)) into its tile; acc +=
// h_c Wproj_c while Wfc_{c+1} loads; every product a wgmma with both
// operands in shared memory. A ragged last chunk (F mod 64 = 32) is padded
// with zero weights (gelu(0) = 0). NP and TAIL: the most 64-column pieces
// and 32-column tails of a warpgroup's fc2 columns (32 and 16
// accumulators).
template <int WGS, int NP, bool TAIL>
__global__ void __launch_bounds__(128 * WGS, WGS == 1 ? 3 : 1)
swin_mlp_kernel(const SwinMlpArgs p) {
  extern __shared__ unsigned char mlp_smem[];
  constexpr int threads = 128 * WGS;
  const int C = p.C, F = p.F;
  const int kb = (C + 63) / 64;              // 64-column boxes of C
  const uint32_t base = (smem_addr(mlp_smem) + kSwzAtomBytes - 1) &
                        ~(uint32_t)(kSwzAtomBytes - 1);
  unsigned char* gen = mlp_smem + (base - smem_addr(mlp_smem));
  const uint32_t ys = base;                          // kb boxes
  const uint32_t wf = ys + kb * kBoxBytes;           // kb boxes
  const uint32_t wp = wf + kb * kBoxBytes;           // kb boxes
  const uint32_t hs = wp + kb * kBoxBytes;           // one box
  float* lns = reinterpret_cast<float*>(gen + (3 * kb + 1) * kBoxBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wr = (warp & 3) * 16;  // warpgroup, its rows
  const int g = lane >> 2, t = lane & 3;
  const int base_row = blockIdx.x * kMlpRows;
  const int per_row = C / 8;
  const int chunks = (F + kMlpChunk - 1) / kMlpChunk;
  // the warpgroup's fc2 columns: 64-column pieces and a 32-column tail
  const int c0 = wg * p.split, width = min(p.split, C - c0);
  const int np64 = width / 64, tail = width % 64;
  const int h0 = WGS == 2 ? 32 * wg : 0;           // its fc1 columns

  // chunk ch's Wfc columns (C x 64) and Wproj rows (64 x C); past F zero
  auto load_wfc = [&](int ch) {
    if (ch >= chunks) return;
    const int f0 = ch * kMlpChunk;
    for (int e = tid; e < C * 8; e += threads) {
      const int k = e >> 3, j = e & 7;
      const bool ok = f0 + j * 8 < F;
      cp_async16(gen + (wf - base) + (k >> 6) * kBoxBytes +
                     (k & 63) * kSwzRowBytes + ((j ^ (k & 7)) << 4),
                 p.wfc + (size_t)k * F + (ok ? f0 + j * 8 : 0), ok);
    }
  };
  auto load_wproj = [&](int ch) {
    const int f0 = ch * kMlpChunk;
    for (int e = tid; e < kMlpChunk * per_row; e += threads) {
      const int r = e / per_row, j = e % per_row;
      const bool ok = f0 + r < F;
      cp_async16(gen + (wp - base) + (j >> 3) * kBoxBytes +
                     r * kSwzRowBytes + (((j & 7) ^ (r & 7)) << 4),
                 p.wproj + (size_t)(ok ? f0 + r : 0) * C + j * 8, ok);
    }
  };

  // o's rows into y2's tile (rows >= M zero), Wfc's first chunk, LN2's
  // parameters
  for (int e = tid; e < kMlpRows * per_row; e += threads) {
    const int m = e / per_row, j = e % per_row;
    const bool ok = base_row + m < p.M;
    cp_async16(gen + swz_off(m, j * 8, kMlpRows),
               p.o + (size_t)(ok ? base_row + m : 0) * C + j * 8, ok);
  }
  load_wfc(0);
  cp_async_commit();
  for (int i = tid; i < C; i += threads) {
    lns[i] = p.ln_s[i];
    lns[C + i] = p.ln_b[i];
  }
  cp_async_wait<0>();
  __syncthreads();
  layernorm_tile<threads / kMlpRows>(
      gen, [&](int m, int j) { return swz_off(m, j * 8, kMlpRows); },
      kMlpRows, C, lns, lns + C, tid, threads);
  fence_proxy_async();

  float acc[NP ? NP : 1][32], tacc[16];
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) tacc[i] = 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
    const int f0 = ch * kMlpChunk;
    __syncthreads();  // y2 / Wfc_ch landed for every thread; Wproj's and
                      // h's tiles free (every warpgroup waited its fc2)
    load_wproj(ch);
    cp_async_commit();

    // fc1: h = y2 Wfc_ch over the warpgroup's 64 (one) or 32 (two)
    // columns, k16 steps four a box, two in a last half box
    constexpr int kH = WGS == 1 ? 32 : 16;  // fc1's accumulators
    float h[kH];
#pragma unroll
    for (int i = 0; i < kH; ++i) h[i] = 0.f;
    fence_acc(h);
    wgmma_fence();
    auto fc1_step = [&](int ks) {
      const uint64_t da = smem_desc(
          ys + (ks >> 2) * kMlpRows * kSwzRowBytes + (ks & 3) * 32,
          kDescLboA, kDescSboA);
      const uint64_t db = smem_desc(
          wf + (ks >> 2) * kBoxBytes + (ks & 3) * 16 * kSwzRowBytes + h0 * 2,
          kDescLboW, kDescSboW);
      if constexpr (WGS == 1)
        Wgmma<64>::mma(h, da, db);
      else
        wgmma_ss32(h, da, db);
    };
    for (int b = 0; b < C / 64; ++b) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fc1_step(4 * b + kk);
    }
    if (C % 64) {
      fc1_step(C / 16 - 2);
      fc1_step(C / 16 - 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(h);
    // h_c = bf16(gelu(h + bfc)) into its tile (columns past F: 0)
#pragma unroll
    for (int j = 0; j < (WGS == 1 ? 8 : 4); ++j) {
      const int col = h0 + 8 * j + 2 * t, f = f0 + col;
      const float b0 = f < F ? to_f(p.bfc[f]) : 0.f;
      const float b1 = f < F ? to_f(p.bfc[f + 1]) : 0.f;
      *reinterpret_cast<unsigned*>(gen + (hs - base) +
                                   swz_off(wr + g, col, kMlpRows)) =
          pack_bf16(activation(h[4 * j] + b0, kGelu),
                    activation(h[4 * j + 1] + b1, kGelu));
      *reinterpret_cast<unsigned*>(gen + (hs - base) +
                                   swz_off(wr + g + 8, col, kMlpRows)) =
          pack_bf16(activation(h[4 * j + 2] + b0, kGelu),
                    activation(h[4 * j + 3] + b1, kGelu));
    }

    cp_async_wait<0>();  // Wproj_ch landed ...
    fence_proxy_async();
    __syncthreads();     // ... and h_c, for every thread; Wfc's tile free
    load_wfc(ch + 1);
    cp_async_commit();

    // fc2: acc += h_c Wproj_ch over the warpgroup's columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = smem_desc(hs + kk * 32, kDescLboA, kDescSboA);
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        if (q < np64)
          Wgmma<64>::mma(acc[q], da,
                         smem_desc(wp + ((c0 >> 6) + q) * kBoxBytes +
                                       kk * 16 * kSwzRowBytes,
                                   kDescLboW, kDescSboW));
      }
      if (TAIL && tail)
        wgmma_ss32(tacc, da,
                   smem_desc(wp + ((c0 >> 6) + np64) * kBoxBytes +
                                 kk * 16 * kSwzRowBytes,
                             kDescLboW, kDescSboW));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < NP; ++q) fence_acc(acc[q]);
    fence_acc(tacc);
    cp_async_wait<0>();  // Wfc_{ch+1} (the next chunk's barrier publishes)
    fence_proxy_async();
  }
  __syncthreads();  // every warpgroup's last fc1 read y2

  // the increment bf16(acc + bproj) over y2, then out = bf16(o + it)
  auto stage = [&](float d0, float d1, float d2, float d3, int col) {
    const float b0 = to_f(p.bproj[col]), b1 = to_f(p.bproj[col + 1]);
    *reinterpret_cast<unsigned*>(gen + swz_off(wr + g, col, kMlpRows)) =
        pack_bf16(d0 + b0, d1 + b1);
    *reinterpret_cast<unsigned*>(gen + swz_off(wr + g + 8, col, kMlpRows)) =
        pack_bf16(d2 + b0, d3 + b1);
  };
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    if (q >= np64) break;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      stage(acc[q][4 * j], acc[q][4 * j + 1], acc[q][4 * j + 2],
            acc[q][4 * j + 3], c0 + 64 * q + 8 * j + 2 * t);
  }
  if (TAIL && tail) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      stage(tacc[4 * j], tacc[4 * j + 1], tacc[4 * j + 2], tacc[4 * j + 3],
            c0 + 64 * np64 + 8 * j + 2 * t);
  }
  __syncthreads();
  for (int e = tid; e < kMlpRows * per_row; e += threads) {
    const int m = e / per_row, j = e % per_row;
    if (base_row + m >= p.M) continue;
    const size_t at = (size_t)(base_row + m) * C + j * 8;
    *reinterpret_cast<uint4*>(p.out + at) =
        add_bf16x8(*reinterpret_cast<const uint4*>(p.o + at),
                   *reinterpret_cast<const uint4*>(gen +
                                                   swz_off(m, j * 8,
                                                           kMlpRows)));
  }
}

// kernel B's warpgroups and their fc2 columns by C: one warpgroup with all
// C columns up to 192 (96 accumulators a thread), two above, warpgroup 0
// the first 64 ceil(C / 128) columns
void mlp_plan(int C, int* wgs, int* split) {
  *wgs = C <= 192 ? 1 : 2;
  *split = C <= 192 ? C : 64 * ((C + 127) / 128);
}

size_t mlp_smem_bytes(int C) {
  const int kb = (C + 63) / 64;
  return (size_t)kSwzAtomBytes + (3 * (size_t)kb + 1) * kBoxBytes +
         8 * (size_t)C;
}

template <int WGS, int NP, bool TAIL>
cudaError_t launch_swin_mlp(const SwinMlpArgs& p, cudaStream_t st,
                            int* launched) {
  static PerDevice smem_set;
  const cudaError_t attr =
      max_dynamic_smem(smem_set, swin_mlp_kernel<WGS, NP, TAIL>, kSmemMax);
  if (attr != cudaSuccess) return attr;
  swin_mlp_kernel<WGS, NP, TAIL>
      <<<(unsigned)((p.M + kMlpRows - 1) / kMlpRows), 128 * WGS,
         mlp_smem_bytes(p.C), st>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[kCountSwinMlp];
  return err;
}

// the instantiation by (warpgroups, 64-column pieces and tail of the
// widest warpgroup's columns, a tail in either warpgroup)
cudaError_t swin_mlp(SwinMlpArgs p, cudaStream_t st, int* launched) {
  int wgs = 1;
  mlp_plan(p.C, &wgs, &p.split);
  const int np = p.split / 64;
  const bool tail = p.C % 64 != 0;
  if (wgs == 1) {
    switch (np * 2 + tail) {
      case 1: return launch_swin_mlp<1, 0, true>(p, st, launched);
      case 2: return launch_swin_mlp<1, 1, false>(p, st, launched);
      case 3: return launch_swin_mlp<1, 1, true>(p, st, launched);
      case 4: return launch_swin_mlp<1, 2, false>(p, st, launched);
      case 5: return launch_swin_mlp<1, 2, true>(p, st, launched);
      case 6: return launch_swin_mlp<1, 3, false>(p, st, launched);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (np * 2 + tail) {
    case 4: return launch_swin_mlp<2, 2, false>(p, st, launched);
    case 5: return launch_swin_mlp<2, 2, true>(p, st, launched);
    case 6: return launch_swin_mlp<2, 3, false>(p, st, launched);
    case 7: return launch_swin_mlp<2, 3, true>(p, st, launched);
    default: return cudaErrorInvalidValue;
  }
}

// a call of common.cuh that launches one kernel, counted as kernel k
#define WT_COUNTED(expr, k) \
  do {                      \
    WT_CHECK(expr);         \
    ++launched[k];          \
  } while (0)

}  // namespace

extern "C" {

// The widest C both entries run as their fused kernels; wider, the chain.
int wt_swin_fused_max_width() { return kSwinFusedMaxC; }

// out_proj(WindowMHA(x) + bias [+ mask]): x (N, L, C) bf16 -> out, same
// shape. mask is null on unshifted blocks. C <= 384: swin_attn_kernel with
// LayerNorm and residual off, qkv and att unused (may be null). Wider: the
// chain, scratch (bf16) qkv (N*L, 3C) and att (N*L, C). launched
// (kCountKinds ints, host memory): each kernel launched adds one to its
// entry (SwinKernel).
int wt_window_attention(const bf16* x, const bf16* wqkv, const bf16* bqkv,
                        const bf16* wo, const bf16* bo, const float* bias,
                        const float* mask, int n_win, bf16* out, bf16* qkv,
                        bf16* att, int N, int L, int C, int H, int* launched,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = N * L;
  if (!gemm_shapes_ok(M, C, C) || !launched)
    return (int)cudaErrorInvalidValue;
  if (C <= kSwinFusedMaxC) {
    if (!swin_attn_ok(N, L, C, H, mask, n_win))
      return (int)cudaErrorInvalidValue;
    const SwinAttnArgs p{x, nullptr, 0, nullptr, nullptr, wqkv, bqkv, wo,
                         bo, bias, mask, mask ? n_win : 1, out, 0, N, L, C,
                         H, 0, 0, 1.f / sqrtf((float)(C / H))};
    WT_CHECK(swin_attention(p, st, launched));
    return 0;
  }
  if (!qkv || !att) return (int)cudaErrorInvalidValue;
  WT_COUNTED((gemm<bf16, kBias>(x, C, wqkv, 3 * C, bqkv, qkv, 3 * C, nullptr,
                                0, kNoMap, M, 3 * C, C, kNone, st)),
             kCountGemm);
  WT_CHECK(window_attention(qkv, bias, mask, n_win, att, N, L, C, H, st,
                            launched));
  WT_COUNTED((gemm<bf16, kBias>(att, C, wo, C, bo, out, C, nullptr, 0, kNoMap,
                                M, C, C, kNone, st)),
             kCountGemm);
  return 0;
}

// The whole Swin block in the bf16 stream: o = x + out_proj(WindowMHA(LN1 x)
// + bias [+ mask]); out = o + fc2(gelu(fc1(LN2 o))). x and out (N*L, C).
// map (map_len,) int32 or null: under a map x and out are spatial rows,
// map_len (a multiple of L dividing N*L) tokens an image, and window-layout
// row r of an image is its spatial row map[r]; without one, window layout.
// C <= 384: swin_attn_kernel (x -> o) and swin_mlp_kernel (o -> out),
// scratch o (N*L, C) bf16, y, qkv, att and h unused (may be null). Wider:
// the chain, window layout only (map null), scratch (bf16) y (N*L, C), qkv
// (N*L, 3C), att (N*L, C), o (N*L, C), h (N*L, F). launched: as for
// wt_window_attention.
int wt_swin_block(const bf16* x, const int* map, int map_len,
                  const float* ln1_s, const float* ln1_b, const bf16* wqkv,
                  const bf16* bqkv, const bf16* wo, const bf16* bo,
                  const float* bias, const float* mask, int n_win,
                  const float* ln2_s, const float* ln2_b, const bf16* wfc,
                  const bf16* bfc, const bf16* wproj, const bf16* bproj,
                  bf16* out, bf16* o, bf16* y, bf16* qkv, bf16* att, bf16* h,
                  int N, int L, int C, int H, int F, int* launched,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = N * L;
  if (!gemm_shapes_ok(M, C, F) || !o || !launched)
    return (int)cudaErrorInvalidValue;
  if (C <= kSwinFusedMaxC) {
    if (!swin_attn_ok(N, L, C, H, mask, n_win) ||
        (map && (map_len < L || map_len % L || M % map_len)))
      return (int)cudaErrorInvalidValue;
    const SwinAttnArgs a{x, map, map_len, ln1_s, ln1_b, wqkv, bqkv, wo, bo,
                         bias, mask, mask ? n_win : 1, o, 1, N, L, C, H, 0,
                         0, 1.f / sqrtf((float)(C / H))};
    WT_CHECK(swin_attention(a, st, launched));
    const SwinMlpArgs b{o, ln2_s, ln2_b, wfc, bfc, wproj, bproj, out, M, C,
                        F, 0};
    WT_CHECK(swin_mlp(b, st, launched));
    return 0;
  }
  if (map || !y || !qkv || !att || !h) return (int)cudaErrorInvalidValue;
  WT_COUNTED(layernorm(x, 0, ln1_s, ln1_b, y, M, C, st), kCountLayerNorm);
  WT_COUNTED((gemm<bf16, kBias>(y, C, wqkv, 3 * C, bqkv, qkv, 3 * C, nullptr,
                                0, kNoMap, M, 3 * C, C, kNone, st)),
             kCountGemm);
  WT_CHECK(window_attention(qkv, bias, mask, n_win, att, N, L, C, H, st,
                            launched));
  WT_COUNTED(gemm_residual(att, C, wo, C, bo, o, C, x, C, kNoMap, 0, M, C, C,
                           st),
             kCountGemm);
  WT_COUNTED(layernorm(o, 0, ln2_s, ln2_b, y, M, C, st), kCountLayerNorm);
  WT_COUNTED((gemm<bf16, kBiasAct>(y, C, wfc, F, bfc, h, F, nullptr, 0,
                                   kNoMap, M, F, C, kGelu, st)),
             kCountGemm);
  WT_COUNTED(gemm_residual(h, F, wproj, C, bproj, out, C, o, C, kNoMap, 0, M,
                           C, F, st),
             kCountGemm);
  return 0;
}

}  // extern "C"
