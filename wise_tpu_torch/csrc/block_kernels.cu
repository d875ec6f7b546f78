// Transformer-block kernels for Hopper (sm_90a): the CLIP towers' residual
// blocks as short chains of hand-written kernels.
//
// Replaces the Pallas TPU kernels of wise_tpu/ops/block.py:
//   wt_attn_block         <- fused_attn_block            (_attn_block_kernel)
//   wt_mlp_block          <- fused_mlp_block             (_mlp_block_kernel)
//   wt_attn_block_pooled  <- fused_attn_block_pooled     (_attn_block_pooled_kernel)
//                            fused_attn_block_pooled_dyn (_attn_block_pooled_dyn_kernel)
//   wt_attention_pooled   <- the attention of those two, alone
//   wt_mlp_fc, wt_mlp_proj <- fused_mlp_split            (_fc_kernel, _proj_kernel)
// the saved-activation forwards of training (the same Pallas kernels with
// one more output):
//   wt_attn_block_res     <- fused_attn_block_res        (_attn_block_kernel, qkv_out)
//   wt_mlp_block_res      <- fused_mlp_block_res         (_mlp_block_kernel, h_out)
//   wt_mlp_fc_res (then wt_mlp_proj)
//                         <- fused_mlp_split_res         (_fc_kernel with hpre_ref)
// the padded-head block's GEMMs (head dims that are not a multiple of 64,
// each head's q/k/v slot zero-padded to 128 lanes in the weights):
//   wt_ln_matmul          <- fused_ln_matmul             (_fc_kernel)
//   wt_residual_matmul    <- fused_residual_matmul       (_proj_kernel)
// the head-split forms of tensor parallelism (a rank's H/mp heads and F/mp
// MLP columns; the same kernels, an f32 partial out, no new device code):
//   wt_attn_block_partial, wt_attn_block_pooled_partial, wt_mlp_proj_partial
//                         <- the blocks above under the reference's 'mp'
//                            sharding (wise_tpu/parallel/train.py:31-46)
// and of wise_tpu/ops/attention.py:
//   wt_short_attention    <- fused_short_attention       (_kernel)
// and of wise_tpu/ops/embed_block.py:
//   wt_embed_attn_block   <- fused_embed_attn_block      (_embed_attn_kernel)
//
// The TPU kernels run a whole block per grid step with the layer weights
// resident in VMEM, because their VMEM holds megabytes and the grid runs in
// order. A Hopper block has at most 227 KB of shared memory and blocks run in
// parallel, so a block here is a chain of launches on one stream:
//
//   layernorm_kernel   f32 statistics (E[x^2] - E[x]^2, flax numerics), bf16 out
//   gemm_kernel        TMA-fed wgmma tiles (a producer warp, one or two
//                      consumer warpgroups), f32 accumulation, fused
//                      epilogue: bias | bias + activation | bias + residual
//                      add (both in common.cuh, shared with swin_kernels.cu)
//   attention_kernel   one (tile of 64 query rows, head, batch) per block,
//                      for head_dim 64, 80, 88 or 104 (and 128 through
//                      wt_short_attention) and up to 640 keys: two passes
//                      over key tiles of 64 (row max and sum online, then
//                      bf16 of the normalised p into PV), K and V
//                      double-buffered by cp.async, S = QK^T and O += PV on
//                      mma.sync with S and P in registers
//                      (attention.cuh, shared with postln_kernels.cu)
//   attention_pooled_kernel
//                      one query row per (example, head): the pooled last
//                      layer's attention, a block per (example, group of
//                      heads) streaming K then V tiles through a cp.async
//                      ring (below). Its q GEMM reads a static pooled row
//                      of LN(x) in place, as a strided operand; per-example
//                      rows are gathered first by gather_rows_kernel
//
// The MLP has one chain in two halves: wt_mlp_fc (LayerNorm, fc GEMM with the
// bias + activation epilogue, h to device memory) and wt_mlp_proj (proj GEMM
// over h with the bias + residual epilogue). wt_mlp_block runs both on
// scratch of its own; the split pair hands h to the caller, as on the TPU,
// where the split exists because both weights do not fit VMEM above width
// 768. Here no weight is resident, so the two wrappers differ only in who
// owns h.
//
// The training forwards hand the backward one buffer each. The attention
// block's qkv GEMM already writes the post-bias qkv (M, 3D) bf16 to device
// memory between its launches, so wt_attn_block and wt_attn_block_res are one
// launch chain and differ only in who owns qkv: the serve entry's scratch, or
// the caller's residual. The MLP's residual is new work: the fc GEMM's
// kBiasActPre epilogue stores bf16(acc + bias) beside bf16(act(acc + bias))
// from the same f32 accumulator, 2 M F more bytes and no second pass. The
// saved value is the rounded one the backward differentiates the activation
// at; h itself still comes from the unrounded accumulator, as in serving
// (the two differ by under one bf16 ulp of h).
//
// wt_short_attention is that attention kernel alone, for the towers that run
// with the block kernels off: it reads q, k and v through their own pointers
// and row strides (three tensors, or the three column ranges of a packed
// in-projection) and takes the softmax scale as an argument. It moves
// 4 M D bf16 values for 4 M keys D operations, ~keys / 2 operations a byte:
// under the card's ~295 at every length the kernel takes, so bytes bound it.
//
// wt_ln_matmul is the MLP's first half with the output in x's dtype and the
// activation optional, wt_residual_matmul its second half under another
// name: the same LayerNorm and GEMM launches. The padded-head block
// (ops/block.py fused_attn_block_padded) chains three wt_ln_matmul, the
// attention at head_dim 128 through wt_short_attention, and one
// wt_residual_matmul: it runs the LayerNorm three times and its q/k/v and
// out-proj GEMMs 128 / hd times as wide as the block's own (1.6x at
// head_dim 80), as the TPU design does.
//
// wt_embed_attn_block (the "embed fold") is the ViT entry and the first
// attention block in one call: the patch GEMM xp (M, PD) x kern (PD, D)
// with the (SP, D) f32 positional + cls table added to the f32 accumulator
// in the epilogue (a RowMap in kRowInExample mode reads table row m mod SP),
// so nothing rounds to bf16 before the add; ln_pre into the residual stream
// (f32, or bf16); then wt_attn_block's chain on that stream. The patch
// product is the one new GEMM shape (K = PD = p * p * 3: 3072 at /32); it is
// compute-bound like the block's.
//
// What bounds them on the H100: the GEMMs hold ~90% of a block's FLOPs and
// are compute-bound at the towers' batch sizes, so the GEMM's tensor-core rate
// decides the block's time; the LayerNorm, softmax and epilogues are
// bandwidth passes over activations. The GEMM is built for that rate: TMA
// loads into a ring of shared-memory stages, wgmma from there, the epilogue
// from registers (common.cuh).
//
// Rounding points follow the TPU kernels: LN(x) rounds to x's dtype and the
// tensor cores take bf16 operands (DEFAULT-precision MXU dots truncate f32 to
// bf16 the same way), so every operand buffer between the launches is bf16;
// qkv, the fc output and the attention output round once, after the bias or
// the f32 accumulation; residual adds happen in x's dtype (f32 or bf16).
//
// The head-split entries take a rank's weights: wqkv (D, 3E) = [q | k | v]
// of its H/mp heads (E = D / mp), wo (E, D) its rows of the out-projection,
// wproj (F/mp, D) its rows of fc2. They run the block's chain with the inner
// width E apart from D (the qkv GEMM D -> 3E, the attention over H/mp heads
// at stride E) and end in the out-proj (or fc2) GEMM E -> D into an f32
// partial with no bias and no residual (gemm<float, kBiasAct> with no bias
// and kNone, the instantiation ln_matmul<float> already makes). The caller
// sums the partials over the ranks and adds the bias and the residual once.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after each launch.

#include "attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// pooled attention: one query row per (example, head), the attention half of
// the pooled last layer. Replaces the attention inside the Pallas TPU
// kernels wise_tpu/ops/block.py _attn_block_pooled_kernel (behind
// fused_attn_block_pooled) and _attn_block_pooled_dyn_kernel (behind
// fused_attn_block_pooled_dyn), which attend an 8-row query window on the
// MXU and slice the pooled row out of it (a Mosaic layout workaround, not
// carried over).
//
// q (B, D) bf16; kv (B * SP, 2D) bf16, each row [k | v]; att (B, D) bf16.
// Per example b and head h: logits q . k_j in f32 times scale; key j is kept
// where j < n_valid and, with causal, j <= row_b (rows[b] clamped into
// [0, SP), or row0); softmax in f32 over the kept keys; p normalised, then
// rounded to bf16 (as p.astype(v.dtype) in the reference); P V in f32;
// att rounded to bf16.
//
// What bounds it: the keys a row keeps are read once each, K then V (2 bytes
// an element, 4 B keys D bytes), for 4 B keys D operations: one operation a
// byte, so bytes bound it (0.1 ms at ViT-H/14's 256 x 257 x 1280). kv comes
// from the kv GEMM just before it and exceeds L2 at the large batches, so
// most reads come from device memory. What the design does about it:
//   - one block of 4 warps per (example, group of G heads), G a power of two
//     dividing H (pooled_group: the largest up to 16 that leaves the grid
//     half the blocks an SM holds, 4 of 8, or 3 of 6 at head dims 88 and
//     104; 1 at the text towers' batches of 8, where the grid stays B x H
//     blocks); the G heads' K (or V) columns of one key row are
//     G * HD * 2 contiguous bytes. 64 registers and 19-25 KB of shared
//     memory at the paths' shapes let 8 blocks share an SM, so ViT-H/14's
//     1,024 blocks run as one wave;
//   - the keys pass in tiles of kPoolSegs / G key rows (kPoolSegs
//     (key, head) segments of HD), K tiles first, then V tiles, through a
//     ring of kPoolStages shared-memory stages fed by 16-byte cp.async
//     copies, consecutive threads on consecutive 16 bytes of a row; the V
//     tiles' copies are in flight while the softmax runs. Tiles at or past
//     the last kept key (n_valid, and row_b + 1 with causal) are not read;
//     rows past it inside the last tile are zero-filled;
//   - the 128 threads form 16 groups of 8 lanes; a group takes kPoolRounds
//     segments of each tile, always of the same head (16 % G == 0). At
//     head_dim 64 a lane reads its 8 columns as one 16-byte word. Otherwise
//     a lane takes the 4-byte words l8 + 8 i of the segment: 5 of 40 at 80;
//     6 or 5 of 44 at 88 and 7 or 6 of 52 at 104 (ViT-g-14, ViT-bigG-14,
//     where HD / 8 is odd and a run of HD / 8 columns a lane would start
//     2-byte aligned at odd lanes), so every lane is busy, the first four
//     one word more at 88 and 104. One read instruction's 8 lanes of a group
//     take 8 consecutive words, and the 4 groups of a warp sit a segment
//     apart: 40 words at 80 and, at 88 and 104, kPoolWideSeg bf16 (56
//     words, not HD) apart in the ring, so that they start 8 or 24 words
//     apart mod 32 and the warp's 32 words fall in 32 distinct banks. The
//     copies move HD / 8 16-byte chunks a segment; the wide segments' pad
//     words are never written, and a lane's word past HD / 2 reads as 0.
//     Logits: each lane's partial dot over its columns, summed
//     by three shuffles, into a shared f32 row of the G heads' logits
//     (SP x G at most), each group keeping its running max. P V: each lane
//     accumulates p times its columns in f32 registers. No thread is idle
//     in either pass;
//   - the softmax is exact in the reference's sense: the group maxima merge
//     per head before any exp, every kept key's exp(logit - max) sums (per
//     thread, then across the warp by shuffles, then across warps) before
//     any p is formed, and p = bf16(e / sum) is rounded once, after the
//     division (a one-pass online softmax rounds other values: PERF.md §6);
//   - the 16 / G groups of one head hold partial outputs over their keys;
//     they meet in shared memory (the dead ring) and sum into att.
// ---------------------------------------------------------------------------

// threads a block; its 8-lane groups; segments a group takes a tile; the
// (key, head) segments of a tile; the ring's stages; heads a block at most
constexpr int kPoolThreads = 128;
constexpr int kPoolGroups = kPoolThreads / 8;
constexpr int kPoolRounds = 2;
constexpr int kPoolSegs = kPoolGroups * kPoolRounds;
constexpr int kPoolStages = 4;
constexpr int kPoolMaxGroup = 16;

// floats of partial maxima (one a group) and sums (one a warp and head)
constexpr int kPoolRed = kPoolGroups + kPoolThreads / 32 * kPoolMaxGroup;

// a segment's bf16 in the ring at head dims 88 and 104 (44 and 52 words
// padded to 56, whose multiples fall 24 words apart mod 32)
constexpr int kPoolWideSeg = 112;

// bf16 from one segment of the ring to the next: HD, padded at the head
// dims whose HD / 8 is odd (88 and 104)
template <int HD>
__host__ __device__ constexpr int pooled_seg() {
  return (HD / 8) % 2 ? kPoolWideSeg : HD;
}
// Blocks an SM (the kernel's launch bounds, and pooled_group's reckoning):
// 8 (64 registers a thread); where the segments are padded, the ring's 28
// KB leaves room for 6 at ViT-g / bigG's 257 keys, so the registers may
// grow to 85
constexpr int kPoolBlocksSm = 8;
constexpr int kPoolWideBlocksSm = 6;
template <int HD>
__host__ __device__ constexpr int pooled_blocks_per_sm() {
  return pooled_seg<HD>() == HD ? kPoolBlocksSm : kPoolWideBlocksSm;
}
// columns a lane holds: 8 at head_dim 64, else 2 x its most words
template <int HD>
__host__ __device__ constexpr int pooled_lane_cols() {
  return HD == 64 ? 8 : 2 * ((HD / 2 + 7) / 8);
}
// the segment column of a lane's column i (at or past HD: none)
template <int HD>
__host__ __device__ constexpr int pooled_col(int l8, int i) {
  return HD == 64 ? l8 * 8 + i : 2 * (l8 + 8 * (i >> 1)) + (i & 1);
}

// dynamic shared memory of one block: the ring, then the logits (p after
// the softmax) of tiles x (kPoolSegs / G) keys x G heads, then kPoolRed
template <int HD>
size_t pooled_smem_bytes(int SP, int G) {
  const int tk = kPoolSegs / G, tiles = (SP + tk - 1) / tk;
  return (size_t)kPoolStages * kPoolSegs * pooled_seg<HD>() * sizeof(bf16) +
         ((size_t)tiles * tk * G + kPoolRed) * sizeof(float);
}

// A lane's columns of the segment at seg as f32 (pooled_col's order): one
// 16-byte read at head_dim 64, else the 4-byte words l8 + 8 i, a word past
// HD / 2 (at 88 and 104, the ring's pad, never written) read as 0
template <int HD>
__device__ __forceinline__ void load_piece(
    const bf16* seg, int l8, float (&f)[pooled_lane_cols<HD>()]) {
  if constexpr (HD == 64) {
    const uint4 u = *reinterpret_cast<const uint4*>(seg + l8 * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(seg);
#pragma unroll
    for (int i = 0; i < pooled_lane_cols<HD>() / 2; ++i) {
      const int w = l8 + 8 * i;
      const bool in = (HD / 2) % 8 == 0 || w < HD / 2;
      const float2 v = __bfloat1622float2(h[w]);
      f[2 * i] = in ? v.x : 0.f;
      f[2 * i + 1] = in ? v.y : 0.f;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kPoolThreads, pooled_blocks_per_sm<HD>())
attention_pooled_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ kv, int D,
                        const int* __restrict__ rows, int row0,
                        bf16* __restrict__ att, int SP, int n_valid,
                        int causal, int lg, float scale) {
  constexpr int E = pooled_lane_cols<HD>();  // columns a lane holds
  constexpr int kChunks = HD / 8;            // 16-byte chunks of a segment
  constexpr int SEG = pooled_seg<HD>();
  constexpr int kStage = kPoolSegs * SEG;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* L = reinterpret_cast<float*>(ring + kPoolStages * kStage);

  const int G = 1 << lg, TK = kPoolSegs >> lg;  // heads, keys of a tile
  const int b = blockIdx.y, h0 = blockIdx.x * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = tid >> 3, l8 = tid & 7, g = gi & (G - 1);
  const int ldkv = 2 * D;
  const int row = pooled_row(rows, row0, b, SP);
  const int kend = causal ? min(n_valid, row + 1) : n_valid;  // keys kept
  const int T = (kend + TK - 1) / TK;                           // key tiles
  float* red = L + T * TK * G;  // kPoolRed floats
  const bf16* kvb = kv + (size_t)b * SP * ldkv + h0 * HD;

  // tile u < T: K of keys [u TK, u TK + TK); u >= T: V of tile u - T
  auto issue = [&](int u) {
    const int key0 = (u < T ? u : u - T) * TK;
    const bf16* src = kvb + (u < T ? 0 : D);
    bf16* dst = ring + (u % kPoolStages) * kStage;
    for (int c = tid; c < kPoolSegs * kChunks; c += kPoolThreads) {
      const int seg = c / kChunks, piece = c - seg * kChunks;
      const int key = key0 + (seg >> lg);
      const bool ok = key < kend;
      cp_async16(dst + seg * SEG + piece * 8,
                 src + (size_t)(ok ? key : 0) * ldkv + (seg & (G - 1)) * HD +
                     piece * 8,
                 ok);
    }
  };
  const int U = 2 * T;
#pragma unroll
  for (int u = 0; u < kPoolStages - 1; ++u) {
    if (u < U) issue(u);
    cp_async_commit();
  }

  float qf[E];
  {
    const bf16* qh = q + (size_t)b * D + (h0 + g) * HD;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int col = pooled_col<HD>(l8, i);
      qf[i] = col < HD ? __bfloat162float(qh[col]) : 0.f;
    }
  }
  float m = -INFINITY;  // the group's running max over its keys
  float acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;

  for (int u = 0; u < U; ++u) {
    if (u + kPoolStages - 1 < U) issue(u + kPoolStages - 1);
    cp_async_commit();
    if (u == T) {
      // the softmax over every kept key, while V's first tiles arrive.
      // Maxima: the groups of one head are gi = g + G k, within a warp
      // 8 G lanes apart
      for (int off = 8 * G; off < 32; off <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (l8 == 0) red[gi] = m;
      __syncthreads();
      const int hh = tid & (G - 1);  // this thread's head in the exp pass
      float mh = -INFINITY;
      for (int k = hh; k < kPoolGroups; k += G) mh = fmaxf(mh, red[k]);
      float sum = 0.f;
      for (int i = tid; i < kend * G; i += kPoolThreads) {
        const float e = expf(L[i] - mh);
        L[i] = e;
        sum += e;
      }
      for (int off = G; off < 32; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane < G) red[kPoolGroups + warp * G + lane] = sum;
      __syncthreads();
      float sh = 0.f;
      for (int w = 0; w < kPoolThreads / 32; ++w)
        sh += red[kPoolGroups + w * G + hh];
      // p rounds to bf16 after the division, as p.astype(v.dtype) does;
      // the rows of the last tile past kend get p = 0
      for (int i = tid; i < T * TK * G; i += kPoolThreads)
        L[i] = i < kend * G ? __bfloat162float(__float2bfloat16(L[i] / sh))
                            : 0.f;
      __syncthreads();
    }
    cp_async_wait<kPoolStages - 1>();
    __syncthreads();
    const bf16* tile = ring + (u % kPoolStages) * kStage;
    if (u < T) {
#pragma unroll
      for (int r = 0; r < kPoolRounds; ++r) {
        const int seg = gi + r * kPoolGroups;
        const int key = u * TK + (seg >> lg);
        float k[E];
        load_piece<HD>(tile + seg * SEG, l8, k);
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) s = fmaf(qf[i], k[i], s);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        const float l = key < kend ? s * scale : -INFINITY;
        if (l8 == 0) L[key * G + g] = l;
        m = fmaxf(m, l);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kPoolRounds; ++r) {
        const int seg = gi + r * kPoolGroups;
        const float p = L[((u - T) * TK + (seg >> lg)) * G + g];
        float v[E];
        load_piece<HD>(tile + seg * SEG, l8, v);
#pragma unroll
        for (int i = 0; i < E; ++i) acc[i] = fmaf(p, v[i], acc[i]);
      }
    }
    __syncthreads();
  }

  // the groups' partial outputs meet in the dead ring: part[gi][HD]
  cp_async_wait<0>();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int col = pooled_col<HD>(l8, i);
    if (col < HD) part[gi * HD + col] = acc[i];
  }
  __syncthreads();
  bf16* out = att + (size_t)b * D + h0 * HD;
  for (int c = tid; c < G * HD; c += kPoolThreads) {
    const int hh = c / HD, col = c - hh * HD;
    float o = 0.f;
    for (int k = hh; k < kPoolGroups; k += G) o += part[k * HD + col];
    out[c] = __float2bfloat16(o);
  }
}

// heads a block of attention_pooled_kernel takes: the largest power of two
// up to kPoolMaxGroup dividing H that still leaves half the blocks an SM
// holds (pooled_blocks_per_sm: 8 at head dims 64 and 80, 6 at 88 and 104)
// busy. At ViT-g-14's and ViT-bigG-14's 256 x 16 heads that is G = 8, one
// wave of 512 blocks; G = 4's 1,024 blocks took 1.3 waves and 12% longer
// (PERF.md §6, group_ms)
int pooled_group(int B, int H, int blocks_per_sm) {
  const long long slots = (long long)(blocks_per_sm / 2) * sm_count();
  int g = 1;
  while (2 * g <= kPoolMaxGroup && H % (2 * g) == 0 &&
         (long long)B * (H / (2 * g)) >= slots)
    g *= 2;
  return g;
}

// dst (B, D) bf16 <- row map_row(g, b) of src (rows of D) for each b, in
// 16-byte pieces (D % 8 == 0): the per-example pooled rows of LN(x), the q
// GEMM's operand
constexpr int kGatherThreads = 128;

__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const bf16* __restrict__ src, RowMap g,
                   bf16* __restrict__ dst, int D) {
  const uint4* s =
      reinterpret_cast<const uint4*>(src + map_row(g, blockIdx.x) * D);
  uint4* d = reinterpret_cast<uint4*>(dst + (size_t)blockIdx.x * D);
  for (int i = threadIdx.x; i < D / 8; i += kGatherThreads) d[i] = s[i];
}

cudaError_t gather_rows(const bf16* src, RowMap g, bf16* dst, int B, int D,
                        cudaStream_t st) {
  gather_rows_kernel<<<B, kGatherThreads, 0, st>>>(src, g, dst, D);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_attention_pooled(const bf16* q, const bf16* kv, int D,
                                    const int* rows, int row0, bf16* att,
                                    int B, int SP, int H, int n_valid,
                                    int causal, int group, cudaStream_t st) {
  const int G =
      group ? group : pooled_group(B, H, pooled_blocks_per_sm<HD>());
  if (G < 1 || G > kPoolMaxGroup || (G & (G - 1)) || H % G)
    return cudaErrorInvalidValue;
  static PerDevice smem_set;
  const cudaError_t attr = max_dynamic_smem(
      smem_set, attention_pooled_kernel<HD>,
      (int)pooled_smem_bytes<HD>(kMaxSeq, kPoolMaxGroup));
  if (attr != cudaSuccess) return attr;
  int lg = 0;
  while ((1 << lg) < G) ++lg;
  attention_pooled_kernel<HD>
      <<<dim3(H / G, B), kPoolThreads, pooled_smem_bytes<HD>(SP, G), st>>>(
          q, kv, D, rows, row0, att, SP, n_valid, causal, lg,
          1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// h = act(fc(LN(x))) as (M, F) bf16; scratch y (M, D) bf16. With h_pre
// (M, F) bf16 the pre-activation fc(LN(x)) is stored there as well.
cudaError_t mlp_fc(const void* x, int x_f32, const float* ln_s,
                   const float* ln_b, const bf16* wfc, const bf16* bfc,
                   bf16* h, bf16* h_pre, bf16* y, int M, int D, int F, int act,
                   cudaStream_t st) {
  cudaError_t err = layernorm(x, x_f32, ln_s, ln_b, y, M, D, st);
  if (err != cudaSuccess) return err;
  if (h_pre)
    return gemm<bf16, kBiasActPre>(y, D, wfc, F, bfc, h, F, nullptr, 0,
                                   kNoMap, M, F, D, act, st, h_pre);
  return gemm<bf16, kBiasAct>(y, D, wfc, F, bfc, h, F, nullptr, 0, kNoMap, M,
                              F, D, act, st);
}

// out = act(LN(x) W + b) in TO (x's dtype); scratch y (M, D) bf16. kBiasAct
// with act = kNone is the bias alone.
template <typename TO>
cudaError_t ln_matmul(const void* x, int x_f32, const float* ln_s,
                      const float* ln_b, const bf16* w, const bf16* b,
                      TO* out, bf16* y, int M, int D, int OW, int act,
                      cudaStream_t st) {
  cudaError_t err = layernorm(x, x_f32, ln_s, ln_b, y, M, D, st);
  if (err != cudaSuccess) return err;
  return gemm<TO, kBiasAct>(y, D, w, OW, b, out, OW, nullptr, 0, kNoMap, M,
                            OW, D, act, st);
}

// out = x + (proj(h) + b) in x's dtype
cudaError_t mlp_proj(const bf16* h, const bf16* wproj, const bf16* bproj,
                     const void* x, int x_f32, void* out, int M, int D, int F,
                     cudaStream_t st) {
  return gemm_residual(h, F, wproj, D, bproj, out, D, x, D, kNoMap, x_f32, M,
                       D, F, st);
}

// The attention block's launch chain; qkv (B*SP, 3D) bf16 holds the
// post-bias in-projection when it returns.
int attn_block(const void* x, int x_f32, const float* ln_s, const float* ln_b,
               const bf16* wqkv, const bf16* bqkv, const bf16* wo,
               const bf16* bo, void* out, bf16* y, bf16* qkv, bf16* att, int B,
               int SP, int D, int H, int n_valid, int causal,
               cudaStream_t st) {
  const int M = B * SP;
  const int hd = head_dim(SP, D, H);
  if (!hd) return (int)cudaErrorInvalidValue;
  WT_CHECK(layernorm(x, x_f32, ln_s, ln_b, y, M, D, st));
  WT_CHECK((gemm<bf16, kBias>(y, D, wqkv, 3 * D, bqkv, qkv, 3 * D, nullptr, 0,
                              kNoMap, M, 3 * D, D, kNone, st)));
  WT_CHECK(attention_packed(hd, qkv, nullptr, att, D, B, SP, H, n_valid,
                            causal, st));
  WT_CHECK(gemm_residual(att, D, wo, D, bo, out, D, x, D, kNoMap, x_f32, M, D,
                         D, st));
  return 0;
}

// out = A W (M, N) f32, no bias, no residual: the head-split entries'
// partials
cudaError_t gemm_partial(const bf16* A, int lda, const bf16* W, int ldw,
                         float* out, int M, int N, int K, cudaStream_t st) {
  return gemm<float, kBiasAct>(A, lda, W, ldw, nullptr, out, N, nullptr, 0,
                               kNoMap, M, N, K, kNone, st);
}

}  // namespace


extern "C" {

// The pooled attention alone (attention_pooled_kernel): q (B, D) bf16,
// kv (B*SP, 2D) bf16 rows [k | v] -> att (B, D) bf16, at each example's row
// rows[b] (device int32, clamped) or row0; keys >= n_valid and, with causal,
// keys past the row dropped. ``group``: heads a block takes (a power of two
// dividing H, at most 16), 0 for pooled_group's choice. No scratch.
int wt_attention_pooled(const bf16* q, const bf16* kv, int D, const int* rows,
                        int row0, bf16* att, int B, int SP, int H, int n_valid,
                        int causal, int group, void* stream) {
  const int hd = head_dim(SP, D, H);
  if (!hd || B < 1 || n_valid < 1 || n_valid > SP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)launch_attention_pooled<64>(q, kv, D, rows, row0, att, B,
                                              SP, H, n_valid, causal, group,
                                              st);
    case 80:
      return (int)launch_attention_pooled<80>(q, kv, D, rows, row0, att, B,
                                              SP, H, n_valid, causal, group,
                                              st);
    case 88:
      return (int)launch_attention_pooled<88>(q, kv, D, rows, row0, att, B,
                                              SP, H, n_valid, causal, group,
                                              st);
    default:
      return (int)launch_attention_pooled<104>(q, kv, D, rows, row0, att, B,
                                               SP, H, n_valid, causal, group,
                                               st);
  }
}

// x + out_proj(MHA(LN1(x))): x (B, SP, D) f32 or bf16 -> out, same shape and
// dtype. Scratch (bf16): y (B*SP, D), qkv (B*SP, 3D), att (B*SP, D).
int wt_attn_block(const void* x, int x_f32, const float* ln_s,
                  const float* ln_b, const bf16* wqkv, const bf16* bqkv,
                  const bf16* wo, const bf16* bo, void* out, bf16* y,
                  bf16* qkv, bf16* att, int B, int SP, int D, int H,
                  int n_valid, int causal, void* stream) {
  return attn_block(x, x_f32, ln_s, ln_b, wqkv, bqkv, wo, bo, out, y, qkv, att,
                    B, SP, D, H, n_valid, causal,
                    static_cast<cudaStream_t>(stream));
}

// The training forward of the attention block: out as wt_attn_block, and the
// post-bias qkv (B*SP, 3D) bf16 as a second output in the caller's memory,
// written once by the qkv GEMM's bias epilogue. Scratch (bf16): y (B*SP, D),
// att (B*SP, D). The arguments stand as wt_attn_block's.
int wt_attn_block_res(const void* x, int x_f32, const float* ln_s,
                      const float* ln_b, const bf16* wqkv, const bf16* bqkv,
                      const bf16* wo, const bf16* bo, void* out, bf16* y,
                      bf16* qkv_out, bf16* att, int B, int SP, int D, int H,
                      int n_valid, int causal, void* stream) {
  return attn_block(x, x_f32, ln_s, ln_b, wqkv, bqkv, wo, bo, out, y, qkv_out,
                    att, B, SP, D, H, n_valid, causal,
                    static_cast<cudaStream_t>(stream));
}

// The attention middle alone: softmax(q k^T * scale, keys >= n_valid and,
// with causal, keys above the query row dropped) v per head. q, k, v are
// (B * SP, D) bf16 with row strides ldq, ldk, ldv (elements); out (B * SP, D)
// bf16, contiguous. No scratch.
int wt_short_attention(const bf16* q, const bf16* k, const bf16* v, int ldq,
                       int ldk, int ldv, bf16* out, int B, int SP, int D,
                       int H, int n_valid, int causal, float scale,
                       void* stream) {
  const int hd = short_head_dim(SP, D, H);
  if (!hd) return (int)cudaErrorInvalidValue;
  return (int)attention(hd, q, k, v, ldq, ldk, ldv, nullptr, out, D, B, SP, H,
                        n_valid, causal, scale,
                        static_cast<cudaStream_t>(stream));
}

// x + proj(act(fc(LN2(x)))): scratch (bf16) y (M, D), h (M, F).
int wt_mlp_block(const void* x, int x_f32, const float* ln_s,
                 const float* ln_b, const bf16* wfc, const bf16* bfc,
                 const bf16* wproj, const bf16* bproj, void* out, bf16* y,
                 bf16* h, int M, int D, int F, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WT_CHECK(mlp_fc(x, x_f32, ln_s, ln_b, wfc, bfc, h, nullptr, y, M, D, F, act,
                  st));
  WT_CHECK(mlp_proj(h, wproj, bproj, x, x_f32, out, M, D, F, st));
  return 0;
}

// The training forward of the MLP block: out as wt_mlp_block, and the
// pre-activation fc output (M, F) bf16 as a second output in the caller's
// memory. Scratch (bf16): y (M, D), h (M, F).
int wt_mlp_block_res(const void* x, int x_f32, const float* ln_s,
                     const float* ln_b, const bf16* wfc, const bf16* bfc,
                     const bf16* wproj, const bf16* bproj, void* out,
                     bf16* h_pre, bf16* y, bf16* h, int M, int D, int F,
                     int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WT_CHECK(mlp_fc(x, x_f32, ln_s, ln_b, wfc, bfc, h, h_pre, y, M, D, F, act,
                  st));
  WT_CHECK(mlp_proj(h, wproj, bproj, x, x_f32, out, M, D, F, st));
  return 0;
}

// The first half of the split MLP: h = act(fc(LN2(x))) as (M, F) bf16 in
// the caller's memory. Scratch (bf16): y (M, D).
int wt_mlp_fc(const void* x, int x_f32, const float* ln_s, const float* ln_b,
              const bf16* wfc, const bf16* bfc, bf16* h, bf16* y, int M, int D,
              int F, int act, void* stream) {
  return (int)mlp_fc(x, x_f32, ln_s, ln_b, wfc, bfc, h, nullptr, y, M, D, F,
                     act, static_cast<cudaStream_t>(stream));
}

// The first half of the split MLP's training forward: h as wt_mlp_fc, and
// the pre-activation fc output (M, F) bf16 beside it, both in the caller's
// memory; wt_mlp_proj closes the block unchanged. Scratch (bf16): y (M, D).
int wt_mlp_fc_res(const void* x, int x_f32, const float* ln_s,
                  const float* ln_b, const bf16* wfc, const bf16* bfc, bf16* h,
                  bf16* h_pre, bf16* y, int M, int D, int F, int act,
                  void* stream) {
  if (!h_pre) return (int)cudaErrorInvalidValue;
  return (int)mlp_fc(x, x_f32, ln_s, ln_b, wfc, bfc, h, h_pre, y, M, D, F, act,
                     static_cast<cudaStream_t>(stream));
}

// The second half: out = x + (proj(h) + b) in x's dtype.
int wt_mlp_proj(const bf16* h, const bf16* wproj, const bf16* bproj,
                const void* x, int x_f32, void* out, int M, int D, int F,
                void* stream) {
  return (int)mlp_proj(h, wproj, bproj, x, x_f32, out, M, D, F,
                       static_cast<cudaStream_t>(stream));
}

// act(LN(x) W + b): x (M, D) f32 or bf16, W (D, OW) bf16, b (OW,) bf16;
// out (M, OW) in x's dtype. act as ACTS (0 none). Scratch (bf16): y (M, D).
int wt_ln_matmul(const void* x, int x_f32, const float* ln_s,
                 const float* ln_b, const bf16* w, const bf16* b, void* out,
                 bf16* y, int M, int D, int OW, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return (int)ln_matmul(x, x_f32, ln_s, ln_b, w, b,
                          static_cast<float*>(out), y, M, D, OW, act, st);
  return (int)ln_matmul(x, x_f32, ln_s, ln_b, w, b, static_cast<bf16*>(out),
                        y, M, D, OW, act, st);
}

// x + (h W + b): h (M, IW) bf16, W (IW, D) bf16, x and out (M, D) in x's
// dtype. No scratch.
int wt_residual_matmul(const bf16* h, const bf16* w, const bf16* b,
                       const void* x, int x_f32, void* out, int M, int D,
                       int IW, void* stream) {
  return (int)mlp_proj(h, w, b, x, x_f32, out, M, D, IW,
                       static_cast<cudaStream_t>(stream));
}

// The ViT entry and the first attention block: xp (B*SP, PD) bf16 patch
// pixels (row 0 of each example and rows >= n_valid zero), kern (PD, D)
// bf16, posc (SP, D) f32 (row 0 holds the class embedding), ln_pre (lnp_*)
// and LN1 (ln_*) f32 -> out (B*SP, D), f32 unless out_f32 is 0 (bf16).
// PD % 8 == 0 (the GEMM's 16-byte rows; the wrapper zero-pads K to a
// multiple of 32). Scratch: t (B*SP, D) f32, xs (B*SP, D) in out's dtype (the
// residual stream after ln_pre), and wt_attn_block's y, qkv, att (bf16).
int wt_embed_attn_block(const bf16* xp, const bf16* kern, const float* posc,
                        const float* lnp_s, const float* lnp_b,
                        const float* ln_s, const float* ln_b,
                        const bf16* wqkv, const bf16* bqkv, const bf16* wo,
                        const bf16* bo, void* out, int out_f32, float* t,
                        void* xs, bf16* y, bf16* qkv, bf16* att, int B,
                        int SP, int PD, int D, int H, int n_valid,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * SP;
  if (!head_dim(SP, D, H)) return (int)cudaErrorInvalidValue;
  const RowMap in_example = {nullptr, 0, SP, kRowInExample};
  WT_CHECK((gemm<float, kBiasResidual>(xp, PD, kern, D, nullptr, t, D,
                                       posc, D, in_example, M, D, PD, kNone,
                                       st)));
  WT_CHECK(out_f32 ? launch_layernorm<float>(t, lnp_s, lnp_b,
                                             static_cast<float*>(xs), M, D, st)
                   : launch_layernorm<float>(t, lnp_s, lnp_b,
                                             static_cast<bf16*>(xs), M, D,
                                             st));
  return attn_block(xs, out_f32, ln_s, ln_b, wqkv, bqkv, wo, bo, out, y, qkv,
                    att, B, SP, D, H, n_valid, 0, st);
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
  if (!head_dim(SP, D, H) || (!rows && (pool_row < 0 || pool_row >= SP)))
    return (int)cudaErrorInvalidValue;
  const RowMap pooled = {rows, pool_row, SP, kGatherPooled};
  WT_CHECK(layernorm(x, x_f32, ln_s, ln_b, y, M, D, st));
  WT_CHECK((gemm<bf16, kBias>(y, D, wqkv + D, 3 * D, bqkv + D, kv, 2 * D,
                              nullptr, 0, kNoMap, M, 2 * D, D, kNone, st)));
  if (rows) {
    // each example's own row of y, gathered into att (free until the
    // attention writes it), is the q GEMM's operand
    WT_CHECK(gather_rows(y, pooled, att, B, D, st));
    WT_CHECK((gemm<bf16, kBias>(att, D, wqkv, 3 * D, bqkv, q, D, nullptr, 0,
                                kNoMap, B, D, D, kNone, st)));
  } else {
    // a static row is a strided view of y: row pool_row of each example,
    // SP * D elements apart (16-byte aligned, as TMA wants: D % 32 == 0)
    WT_CHECK((gemm<bf16, kBias>(y + (size_t)pool_row * D, SP * D, wqkv,
                                3 * D, bqkv, q, D, nullptr, 0, kNoMap, B, D,
                                D, kNone, st)));
  }
  WT_CHECK((cudaError_t)wt_attention_pooled(q, kv, D, rows, pool_row, att, B,
                                            SP, H, n_valid, causal, 0,
                                            stream));
  WT_CHECK(gemm_residual(att, D, wo, D, bo, out, D, x, D, pooled, x_f32, B, D,
                         D, st));
  return 0;
}

// The head-split attention chain: x (B, SP, D) f32 or bf16, wqkv (D, 3E)
// bf16, bqkv (3E,) bf16, wo (E, D) bf16 -> partial (B*SP, D) f32 = MHA over
// the H heads of width E (E / H in 64, 80, 88, 104) times wo, no bias or
// residual. qkv (B*SP, 3E) bf16 holds the post-bias in-projection when it
// returns (the training backward's residual). Scratch (bf16): y (B*SP, D),
// att (B*SP, E).
int wt_attn_block_partial(const void* x, int x_f32, const float* ln_s,
                          const float* ln_b, const bf16* wqkv,
                          const bf16* bqkv, const bf16* wo, float* partial,
                          bf16* y, bf16* qkv, bf16* att, int B, int SP, int D,
                          int E, int H, int n_valid, int causal,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * SP;
  const int hd = head_dim(SP, E, H);
  if (!hd || E % 8 != 0) return (int)cudaErrorInvalidValue;
  WT_CHECK(layernorm(x, x_f32, ln_s, ln_b, y, M, D, st));
  WT_CHECK((gemm<bf16, kBias>(y, D, wqkv, 3 * E, bqkv, qkv, 3 * E, nullptr, 0,
                              kNoMap, M, 3 * E, D, kNone, st)));
  WT_CHECK(attention_packed(hd, qkv, nullptr, att, E, B, SP, H, n_valid,
                            causal, st));
  WT_CHECK(gemm_partial(att, E, wo, D, partial, M, D, E, st));
  return 0;
}

// The head-split pooled chain at one row per example: rows[b] when rows is
// given (device int32, clamped), else pool_row. The weights stand as
// wt_attn_block_partial's; partial (B, D) f32, no bias or residual. Scratch
// (bf16): y (B*SP, D), yrows (B, D) (the gathered rows of y), kv (B*SP, 2E),
// q (B, E), att (B, E).
int wt_attn_block_pooled_partial(const void* x, int x_f32, const float* ln_s,
                                 const float* ln_b, const bf16* wqkv,
                                 const bf16* bqkv, const bf16* wo,
                                 const int* rows, int pool_row,
                                 float* partial, bf16* y, bf16* yrows,
                                 bf16* kv, bf16* q, bf16* att, int B, int SP,
                                 int D, int E, int H, int n_valid, int causal,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * SP;
  if (!head_dim(SP, E, H) || E % 8 != 0 ||
      (!rows && (pool_row < 0 || pool_row >= SP)))
    return (int)cudaErrorInvalidValue;
  WT_CHECK(layernorm(x, x_f32, ln_s, ln_b, y, M, D, st));
  WT_CHECK((gemm<bf16, kBias>(y, D, wqkv + E, 3 * E, bqkv + E, kv, 2 * E,
                              nullptr, 0, kNoMap, M, 2 * E, D, kNone, st)));
  if (rows) {
    const RowMap pooled = {rows, pool_row, SP, kGatherPooled};
    WT_CHECK(gather_rows(y, pooled, yrows, B, D, st));
    WT_CHECK((gemm<bf16, kBias>(yrows, D, wqkv, 3 * E, bqkv, q, E, nullptr, 0,
                                kNoMap, B, E, D, kNone, st)));
  } else {
    WT_CHECK((gemm<bf16, kBias>(y + (size_t)pool_row * D, SP * D, wqkv,
                                3 * E, bqkv, q, E, nullptr, 0, kNoMap, B, E,
                                D, kNone, st)));
  }
  WT_CHECK((cudaError_t)wt_attention_pooled(q, kv, E, rows, pool_row, att, B,
                                            SP, H, n_valid, causal, 0,
                                            stream));
  WT_CHECK(gemm_partial(att, E, wo, D, partial, B, D, E, st));
  return 0;
}

// The head-split MLP's second half: partial (M, D) f32 = h (M, F) bf16 times
// wproj (F, D) bf16, F the rank's columns; no bias or residual. The first
// half is wt_mlp_fc or wt_mlp_fc_res at F. No scratch.
int wt_mlp_proj_partial(const bf16* h, const bf16* wproj, float* partial,
                        int M, int D, int F, void* stream) {
  return (int)gemm_partial(h, F, wproj, D, partial, M, D, F,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
