// Fused inner-product scan + top-k over a device-resident vector database
// (sm_90a). Replaces the two Pallas kernels of wise_tpu/ops/pallas_topk.py:
// pallas_topk (_group_topk_kernel: each row group's own top-k) and
// pallas_topk_threshold (_threshold_topk_kernel: one running top-k carried
// over the groups, a group's extraction skipped unless its max beats the
// running k-th score).
//
// Bound: bytes. Every database row is read once (N * D * itemsize bytes
// against 2 * Q * N * D operations: 1 to 64 operations a byte at the serve
// shapes, far under the ~295 a byte the card needs to leave the memory
// bound), so the designs spend their effort on reading the rows once for
// as many queries as they can and on keeping the selection off the
// critical path.
//
// Two designs:
//
// 1. pallas_topk, the batched search's path, on either storage type: the
//    wrapper (ops/fused_topk.py group_topk_chunks) cuts the work into chunks
//    of whole groups by at most 64 queries and, for each chunk, writes Sᵀ
//    (rows, Q_pad) f32 with a product kernel, then keeps each group's top-k
//    of each query with one selection kernel. At 1,048,576 x 512 the bound
//    is the database read (1.07 GB bf16, 0.32 ms; 2.15 GB f32, 0.64 ms at
//    3.35 TB/s) plus the Sᵀ scratch, 256 MB written and read again at Q =
//    64 (0.16 ms more). Both products read the rows once for up to 64
//    queries on the tensor cores:
//      - bf16 storage, wt_topk_gemm: the port's GEMM (common.cuh
//        gemm_kernel: TMA + wgmma, f32 accumulators, bias-free epilogue) on
//        A = the rows as they lie, W = bf16(q)ᵀ (D, Q_pad): bf16 products
//        are exact in f32 and the sums stay f32;
//      - f32 storage, wt_topk_gemm_f32 (topk_gemm_f32_kernel): f32 scores
//        to f32 accuracy from three TF32 products (3xTF32): each value x
//        splits into hi = tf32(x), rounded to nearest, and lo = tf32(x -
//        hi); S = hi q_hi + hi q_lo + lo q_hi in f32. The dropped lo q_lo
//        and lo's rounding are ~2^-22 of each product (under 1e-6 at unit
//        vectors), and on integer-valued vectors lo = 0 and every sum is
//        exact. The rows go by TMA into a ring as they lie (f32 A); tf32
//        wgmma takes only K-major operands, so the consumers split A from
//        shared memory into registers (the register-A form) and the wrapper
//        passes q_hi and q_lo as (Q_pad, D) rows.
//    wt_topk_select (topk_select_kernel) gives one CTA to each (group, tile
//    of 8 queries) and selects from a lower bound instead of inserting every
//    better row into a buffer: the k-th largest of 256 block maxima, τ, is
//    <= the group's k-th best score (k blocks each hold a score >= τ), so
//    only rows >= τ can be in the top k (~3% of a group at random scores,
//    ~125 of 4,096 at k = 100). They are compacted and sorted, and the first
//    k kept; ties at τ that overflow the buffer take the insertion below over
//    the survivors alone. The next step is the selection fused into the
//    product's epilogue, which drops the Sᵀ round trip.
//
// 2. pallas_topk_threshold (wt_topk_threshold) scans with scalar FMAs: the
//    served query's path (Q = 1, and small batches). f32 storage scores in
//    full f32. The TPU kernel walks the groups one after another on one
//    core with one running buffer. Here the grid is (query tiles, row
//    spans): a CTA owns a contiguous span of whole groups, sized by the
//    caller so that the grid fills the card, and a tile of up to 8 queries
//    held in shared memory, streams its rows in tiles of kTile, and keeps
//    its span's running top-k per query in shared memory.
//      scoring: a warp takes kRows rows at a time; its lanes read the rows
//        in 16-byte pieces (neighbouring lanes, neighbouring addresses) and
//        multiply them with the queries from shared memory: f32 FMAs; bf16
//        storage meets the query rounded to bf16, products and sums in f32.
//        The partial sums of the kRows x QT accumulators are reduced across
//        the warp by a butterfly that halves the accumulators at each step.
//        Rows >= n_valid (zero padding, which would outscore negative true
//        scores) and rows past the span become -inf before any selection.
//
// The scan's selection (select_tile): warp q owns query q's buffer, (score,
// row) pairs, unsorted, with the worst entry (lowest score, on ties the
// highest row) known. A tile's scores are compared with the worst entry:
// where none is better (a ballot) the 32 rows are skipped, which is the
// threshold skip. A better candidate replaces the worst entry, and the worst
// is found anew (k / 32 entries a lane and a warp reduction). "Better" is the
// total order (score descending, row ascending), so the buffer holds the
// first k in that order whatever the order of insertion: the one intended
// difference from the TPU threshold kernel, which evicts the first lane among
// tied worsts. Both designs keep that order. Nothing carries over between
// CTAs: each writes its k candidates, and the wrapper merges the (slots, Q,
// k) candidates with torch ops, as the merge is outside both Pallas kernels.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;   // rows scored between two selections
constexpr int kMaxQT = 8;    // queries a CTA holds

__device__ __forceinline__ bool better(float s, int r, float ws, int wr) {
  return s > ws || (s == ws && r < wr);
}

// Sum NACC (a power of two <= 32) accumulators across the warp. On return
// a[0] of lane l holds the complete sum of accumulator l >> (5 - log2(NACC)).
// Every index is a compile-time constant once the loops are unrolled, so the
// accumulators stay in registers.
template <int NACC>
__device__ __forceinline__ void warp_reduce_scatter(float (&a)[NACC], int lane) {
  constexpr int kSteps = NACC == 1 ? 0 : NACC == 2 ? 1 : NACC == 4 ? 2
                         : NACC == 8 ? 3 : NACC == 16 ? 4 : 5;
  static_assert((1 << kSteps) == NACC, "NACC must be a power of two <= 32");
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int half = NACC >> (s + 1), off = 16 >> s;
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < NACC / 2; ++i) {
      if (i < half) {
        const float send = upper ? a[i] : a[i + half];
        const float keep = upper ? a[i + half] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    }
  }
#pragma unroll
  for (int s = kSteps; s < 5; ++s)
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], 16 >> s);
}

// 16 bytes of a row as floats: 4 of f32 storage, 8 of bf16 storage.
template <typename T> struct Piece;
template <> struct Piece<float> {
  static constexpr int kElems = 4;
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};
template <> struct Piece<bf16> {
  static constexpr int kElems = 8;
  float v[8];
  __device__ __forceinline__ void load(const bf16* p) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    // a bf16 is the high half of an f32
    v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xffff0000u);
    v[4] = __uint_as_float(t.z << 16); v[5] = __uint_as_float(t.z & 0xffff0000u);
    v[6] = __uint_as_float(t.w << 16); v[7] = __uint_as_float(t.w & 0xffff0000u);
  }
};

// The worst entry of a k-entry buffer (lowest score, on ties the highest
// row) and its position, the same in every lane.
__device__ __forceinline__ void find_worst(const float* bs, const int* br,
                                           int k, int lane, float& ws,
                                           int& wr, int& wpos) {
  float s = INFINITY;
  int r = -1, pos = 0;
  for (int i = lane; i < k; i += 32) {
    const float si = bs[i];
    const int ri = br[i];
    if (si < s || (si == s && ri > r)) { s = si; r = ri; pos = i; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    const int ro = __shfl_xor_sync(0xffffffffu, r, off);
    const int po = __shfl_xor_sync(0xffffffffu, pos, off);
    if (so < s || (so == s && ro > r)) { s = so; r = ro; pos = po; }
  }
  ws = s; wr = r; wpos = pos;
}

// The selection of one tile for one query, by one warp: the scores
// my_sc[0, N) (N a multiple of 32) of database rows row0, row0 + 1, ...
// enter the warp's k-entry buffer (my_bs, my_br) whose worst entry is
// (ws, wr) at wpos. -inf scores (masked rows) never enter.
template <int N>
__device__ __forceinline__ void select_tile(const float* my_sc, int row0,
                                            int k, int lane, float* my_bs,
                                            int* my_br, float& ws, int& wr,
                                            int& wpos) {
  for (int j = lane; j < N; j += 32) {
    const float s = my_sc[j];
    const int row = row0 + j;
    // the threshold skip: nothing of these 32 rows beats the worst entry
    unsigned m = __ballot_sync(
        0xffffffffu, s != -INFINITY && better(s, row, ws, wr));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cs = __shfl_sync(0xffffffffu, s, src);
      const int cr = __shfl_sync(0xffffffffu, row, src);
      if (better(cs, cr, ws, wr)) {  // the worst may have risen since
        if (lane == 0) { my_bs[wpos] = cs; my_br[wpos] = cr; }
        __syncwarp();
        find_worst(my_bs, my_br, k, lane, ws, wr, wpos);
      }
    }
  }
}

// One CTA: queries [q0, q0 + QT) against rows [row_begin, row_end), the
// span's top-k of each query written to slot ``slot`` of (slots, Q, k).
template <typename T, int QT>
__device__ void scan_span(const float* __restrict__ queries,
                          const T* __restrict__ db, float* __restrict__ out_s,
                          int* __restrict__ out_r, int Q, int D, int n_valid,
                          int k, int q0, int row_begin, int row_end,
                          int slot) {
  constexpr int kRows = QT == 1 ? 4 : 2;  // rows a warp scores at a time
  constexpr int NACC = kRows * QT;
  constexpr int E = Piece<T>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // (QT, D) queries
  float* sc = sq + QT * D;                     // (QT, kTile) scores
  float* bs = sc + QT * kTile;                 // (QT, k) buffer scores
  int* br = reinterpret_cast<int*>(bs + QT * k);  // (QT, k) buffer rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < QT * D; i += kThreads) {
    const int q = q0 + i / D;
    float v = q < Q ? queries[(size_t)q * D + i % D] : 0.f;
    if (sizeof(T) == 2) v = __bfloat162float(__float2bfloat16_rn(v));
    sq[i] = v;
  }
  for (int i = tid; i < QT * k; i += kThreads) {
    bs[i] = -INFINITY;
    br[i] = INT_MAX;  // an empty slot: worse than every row
  }
  __syncthreads();

  // the selecting warps' view of their query's buffer
  const bool selects = warp < QT && q0 + warp < Q;
  float ws = -INFINITY;
  int wr = INT_MAX, wpos = 0;
  float* my_bs = bs + warp * k;
  int* my_br = br + warp * k;

  const int pieces = D / E;
  for (int tile0 = row_begin; tile0 < row_end; tile0 += kTile) {
    // scoring: warp w takes rows w * kRows .. of each kWarps * kRows rows
    for (int t = warp * kRows; t < kTile; t += kWarps * kRows) {
      float acc[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
      const T* rp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // rows past the span are read from its last row and masked below
        const int row = min(tile0 + t + r, row_end - 1);
        rp[r] = db + (size_t)row * D;
      }
#pragma unroll 2
      for (int c = lane; c < pieces; c += 32) {
        Piece<T> p[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) p[r].load(rp[r] + c * E);
#pragma unroll
        for (int q = 0; q < QT; ++q) {
          const float4* qp =
              reinterpret_cast<const float4*>(sq + q * D + c * E);
#pragma unroll
          for (int e = 0; e < E / 4; ++e) {
            const float4 qv = qp[e];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              float a = acc[r * QT + q];
              a = fmaf(p[r].v[4 * e], qv.x, a);
              a = fmaf(p[r].v[4 * e + 1], qv.y, a);
              a = fmaf(p[r].v[4 * e + 2], qv.z, a);
              a = fmaf(p[r].v[4 * e + 3], qv.w, a);
              acc[r * QT + q] = a;
            }
          }
        }
      }
      warp_reduce_scatter<NACC>(acc, lane);
      constexpr int kShare = 32 / NACC;  // lanes that hold one sum
      if (lane % kShare == 0) {
        const int j = lane / kShare, r = j / QT, q = j % QT;
        const int row = tile0 + t + r;
        sc[q * kTile + t + r] =
            (row < row_end && row < n_valid) ? acc[0] : -INFINITY;
      }
    }
    __syncthreads();

    // selection: warp q holds query q's buffer
    if (selects)
      select_tile<kTile>(sc + warp * kTile, tile0, k, lane, my_bs, my_br, ws,
                         wr, wpos);
    __syncthreads();
  }

  for (int i = tid; i < QT * k; i += kThreads) {
    const int q = q0 + i / k;
    if (q >= Q) continue;
    const size_t o = ((size_t)slot * Q + q) * k + i % k;
    out_s[o] = bs[i];
    out_r[o] = br[i] == INT_MAX ? 0 : br[i];  // an empty slot: (-inf, row 0)
  }
}

template <typename T, int QT>
__global__ void __launch_bounds__(kThreads)
topk_span_kernel(const float* __restrict__ queries, const T* __restrict__ db,
                 float* __restrict__ out_s, int* __restrict__ out_r, int Q,
                 int D, int n_rows, int n_valid, int k, int span_rows) {
  const long long begin = (long long)blockIdx.y * span_rows;
  const int row_begin = (int)begin;
  const int row_end = (int)min(begin + span_rows, (long long)n_rows);
  scan_span<T, QT>(queries, db, out_s, out_r, Q, D, n_valid, k,
                   blockIdx.x * QT, row_begin, row_end, blockIdx.y);
}

template <typename T, int QT>
cudaError_t launch_qt(const float* queries, const T* db, float* out_s,
                      int* out_r, int Q, int D, int n_rows, int n_valid,
                      int k, int span_rows, cudaStream_t st) {
  const size_t smem =
      ((size_t)QT * D + (size_t)QT * kTile + 2 * (size_t)QT * k) * 4;
  auto kernel = topk_span_kernel<T, QT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int spans = (n_rows + span_rows - 1) / span_rows;
  const dim3 grid((Q + QT - 1) / QT, spans);
  kernel<<<grid, kThreads, smem, st>>>(queries, db, out_s, out_r, Q, D,
                                       n_rows, n_valid, k, span_rows);
  return cudaGetLastError();
}

// queries (Q, D) f32, db (n_rows, D) f32 (bf16_db 0) or bf16 (1), rows of 16
// bytes' alignment -> out_s, out_r (spans, Q, k), spans = ceil(n_rows /
// span_rows): each span's first k of (score descending, row ascending),
// unsorted; a span with fewer than k valid rows fills up with (-inf, 0).
cudaError_t launch(const float* queries, const void* db, int bf16_db,
                   float* out_s, int* out_r, int Q, int D, int n_rows,
                   int n_valid, int k, int span_rows, cudaStream_t st) {
  if (Q < 1 || D < 8 || D % 8 || D > 1024 || n_rows < 1 || k < 1 ||
      k > 1024 || span_rows < 1 || n_valid < 0 || n_valid > n_rows ||
      (n_rows + span_rows - 1) / span_rows > 65535)
    return cudaErrorInvalidValue;
  if (bf16_db) {
    const bf16* d = static_cast<const bf16*>(db);
    return Q == 1 ? launch_qt<bf16, 1>(queries, d, out_s, out_r, Q, D, n_rows,
                                       n_valid, k, span_rows, st)
                  : launch_qt<bf16, kMaxQT>(queries, d, out_s, out_r, Q, D,
                                            n_rows, n_valid, k, span_rows,
                                            st);
  }
  const float* d = static_cast<const float*>(db);
  return Q == 1 ? launch_qt<float, 1>(queries, d, out_s, out_r, Q, D, n_rows,
                                      n_valid, k, span_rows, st)
                : launch_qt<float, kMaxQT>(queries, d, out_s, out_r, Q, D,
                                           n_rows, n_valid, k, span_rows, st);
}

// ---------------------------------------------------------------------------
// The f32 group path's product: Sᵀ (rows, Q_pad) f32 = db q̂ᵀ in three TF32
// terms on wgmma (wt_topk_gemm_f32)
// ---------------------------------------------------------------------------

constexpr int kF32BK = 32;       // f32 K per stage: one 128-byte swizzled row
constexpr int kF32BN = 64;       // queries a tile holds: a chunk's Q_pad <= 64
constexpr int kF32Tiles = 1;     // m64 tiles a consumer warpgroup owns
constexpr int kF32Wg = 2;        // consumer warpgroups
constexpr int kF32BM = kF32Wg * kF32Tiles * kWgRows;  // rows of a tile
constexpr int kF32WgmmaK = 8;    // K of one tf32 wgmma: 32 bytes
constexpr int kF32ABytes = kF32BM * kSwzRowBytes;     // the rows' box
constexpr int kF32QBytes = kF32BN * kSwzRowBytes;     // q_hi's or q_lo's box
constexpr int kF32StageBytes = kF32ABytes + 2 * kF32QBytes;
// as many stages as fit one block an SM beside the atom of alignment room
constexpr int kF32Stages =
    (kSmemPerSM - 1024 - kSwzAtomBytes) / (kF32StageBytes + 16);
constexpr int kF32Threads = kF32Wg * 128 + 32;  // consumers + producer warp
constexpr size_t kF32Smem =
    (size_t)kF32Stages * (kF32StageBytes + 16) + kSwzAtomBytes;

// One k8 step of one m64 tile's A fragment split in two: hi = tf32(x), lo =
// tf32(x - hi) (the subtraction is exact in f32)
__device__ __forceinline__ void split_frag(float x0, float x1, float x2,
                                           float x3, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const float x[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// A persistent block walks the kF32BM-row tiles blockIdx.x, blockIdx.x +
// gridDim.x, ...; threads [0, 128 kF32Wg) are the consumer warpgroups, of
// kF32Tiles m64 tiles each, the last warp the producer. A stage holds the
// tile's rows x 32 columns (one TMA box, 128-byte swizzle) and the same 32
// columns of q_hi and of q_lo (64 rows each). Thread (g = lane / 4, t =
// lane % 4) of a warp reads, for each of its m64 tiles, physical columns
// 8t .. 8t + 7 of its rows g and g + 8 as two 16-byte pieces each (chunks
// 2t and 2t + 1, swizzled by the row: c ^ g); k8 step kk takes physical
// column 8t + 2kk as logical column t and 8t + 2kk + 1 as t + 4. The
// wrapper permutes q's columns to match (ops/fused_topk.py tf32_split).
// Each k8 step issues lo.q_hi, hi.q_lo and hi.q_hi on its tiles as one
// commit group; the fragments are double-buffered by the step's parity, so
// one group stays in flight while the next is split and issued. A stage's
// 12 products a tile go into accumulators of their own, added to the f32
// sums once the stage is done: the tensor cores' own f32 sums lose low bits
// over many steps (4.9e-06 at scores near 1 when one accumulator took all
// 192 products of K = 512, 1.3e-07 at unit scores this way). Two sets of
// accumulators are why a warpgroup owns one m64 tile: a block of 9 warps
// gets at most 168 registers a thread, and two tiles spilled.
__global__ void __launch_bounds__(kF32Threads, 1)
topk_gemm_f32_kernel(const __grid_constant__ CUtensorMap tma_db,
                     const __grid_constant__ CUtensorMap tma_q,
                     float* __restrict__ out, int M, int N, int K) {
  constexpr int S = kF32Stages;
  extern __shared__ unsigned char f32_smem[];
  const uint32_t ring = (smem_addr(f32_smem) + kSwzAtomBytes - 1) &
                        ~(uint32_t)(kSwzAtomBytes - 1);
  const uint32_t full = ring + S * kF32StageBytes;
  const uint32_t empty = full + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (M + kF32BM - 1) / kF32BM;
  const int KT = (K + kF32BK - 1) / kF32BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kF32Wg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kF32Wg) {  // producer
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);
          const uint32_t a_s = ring + s * kF32StageBytes;
          const uint32_t q_s = a_s + kF32ABytes;
          mbar_expect_tx(full + 8 * s, kF32StageBytes);
          tma_load_2d(a_s, &tma_db, kt * kF32BK, tile * kF32BM, full + 8 * s);
          // q_hi is rows [0, N) of the map, q_lo rows [N, 2N)
          tma_load_2d(q_s, &tma_q, kt * kF32BK, 0, full + 8 * s);
          tma_load_2d(q_s + kF32QBytes, &tma_q, kt * kF32BK, N, full + 8 * s);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  // the f32 sums, and one stage's products on the tensor cores, added to
  // them in f32 once the stage is done
  float acc[kF32Tiles][32], part[kF32Tiles][32];
  uint32_t hi[2][kF32Tiles][4], lo[2][kF32Tiles][4];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int t = 0; t < kF32Tiles; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) hi[b][t][i] = lo[b][t][i] = 0u;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int t = 0; t < kF32Tiles; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(full + 8 * s, (it / S) & 1);
      const uint32_t stage = ring + s * kF32StageBytes;
      // v[t][h]: physical columns 8 t4 .. + 7 of row g + 8h of m64 tile t
      float v[kF32Tiles][2][8];
#pragma unroll
      for (int t = 0; t < kF32Tiles; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (wg * kF32Tiles + t) * kWgRows + (warp & 3) * 16 +
                          g + 8 * h;
          const uint32_t base = stage + row * kSwzRowBytes;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint32_t addr = base + (((2 * t4 + c) ^ g) << 4);
            asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                         : "=f"(v[t][h][4 * c]), "=f"(v[t][h][4 * c + 1]),
                           "=f"(v[t][h][4 * c + 2]), "=f"(v[t][h][4 * c + 3])
                         : "r"(addr));
          }
        }
      const uint32_t q_hi = stage + kF32ABytes, q_lo = q_hi + kF32QBytes;
#pragma unroll
      for (int kk = 0; kk < kF32BK / kF32WgmmaK; ++kk) {
        const int b = kk & 1;
#pragma unroll
        for (int t = 0; t < kF32Tiles; ++t)
          split_frag(v[t][0][2 * kk], v[t][1][2 * kk], v[t][0][2 * kk + 1],
                     v[t][1][2 * kk + 1], hi[b][t], lo[b][t]);
#pragma unroll
        for (int t = 0; t < kF32Tiles; ++t) {
          fence_frag(hi[b][t]);
          fence_frag(lo[b][t]);
          fence_acc(part[t]);
        }
        wgmma_fence();
        const uint64_t dh = smem_desc(q_hi + kk * kF32WgmmaK * 4, kDescLboA,
                                      kDescSboA);
        const uint64_t dl = smem_desc(q_lo + kk * kF32WgmmaK * 4, kDescLboA,
                                      kDescSboA);
#pragma unroll
        for (int t = 0; t < kF32Tiles; ++t) {
          WgmmaTf32::mma(part[t], lo[b][t], dh, kk > 0);
          WgmmaTf32::mma(part[t], hi[b][t], dl, 1);
          WgmmaTf32::mma(part[t], hi[b][t], dh, 1);
        }
        wgmma_commit();
#pragma unroll
        for (int t = 0; t < kF32Tiles; ++t) fence_acc(part[t]);
        // the previous step's group is done: its fragments may be rewritten
        wgmma_wait<1>();
#pragma unroll
        for (int t = 0; t < kF32Tiles; ++t) {
          fence_acc(part[t]);
          fence_frag(hi[b ^ 1][t]);
          fence_frag(lo[b ^ 1][t]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < kF32Tiles; ++t) {
        fence_acc(part[t]);
        fence_frag(hi[0][t]);
        fence_frag(lo[0][t]);
        fence_frag(hi[1][t]);
        fence_frag(lo[1][t]);
      }
      // the stage's products are done: the stage goes back to the
      // producer, and they join the sums in f32
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int t = 0; t < kF32Tiles; ++t)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[t][i] += part[t][i];
    }

    const int col = (lane & 3) * 2;
    const RowMap as_is = {nullptr, 0, 0, kRowsAsIs};
#pragma unroll
    for (int t = 0; t < kF32Tiles; ++t) {
      const int row = tile * kF32BM + (wg * kF32Tiles + t) * kWgRows +
                      (warp & 3) * 16 + g;
      store_tile<float, kBias, float, kF32BN, kNone>(
          acc[t], row, col, M, N, nullptr, out, N, nullptr, 0, as_is,
          nullptr);
    }
  }
}

// ---------------------------------------------------------------------------
// The group selection of both storage types: Sᵀ -> each group's top-k
// (wt_topk_select)
// ---------------------------------------------------------------------------

constexpr int kSelQ = 8;                 // queries a CTA selects for
constexpr int kSelThreads = 32 * kSelQ;  // one warp a query
constexpr int kSegRows = 2048;           // group rows held at a time
// a query's keys in shared memory; the pad of 4 puts the two halves of a
// row's 8 scores 16 banks apart, so the transposing stores meet no bank twice
constexpr int kSegStride = kSegRows + 4;
// 16-byte loads a thread makes for a segment (4 scores of one row each)
constexpr int kSegLoads = kSegRows * kSelQ / 4 / kSelThreads;
constexpr int kLaneBlocks = 8;  // block maxima a lane keeps: 256 a warp
constexpr int kTauBits = 16;    // leading bits of τ the search settles

// The order-preserving key of a score (-0 taken as +0, so that equal scores
// give equal keys); every score's key is >= 0x007fffff (that of -inf), and
// key 0 marks a row that takes no part (past the group, or >= n_valid).
__device__ __forceinline__ uint32_t score_key(float s) {
  const uint32_t u = __float_as_uint(s + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// A candidate as one 64-bit word: the key above ~row, so that the larger
// word is the better entry by (score descending, row ascending); 0 is the
// empty entry, worse than every row.
__device__ __forceinline__ uint64_t pack(uint32_t key, int row) {
  return ((uint64_t)key << 32) | (uint32_t)~row;
}

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
  const uint32_t lo = __shfl_sync(0xffffffffu, (uint32_t)v, src);
  const uint32_t hi = __shfl_sync(0xffffffffu, (uint32_t)(v >> 32), src);
  return ((uint64_t)hi << 32) | lo;
}

// Sort buf[0, n) descending, n a power of two >= 32, by one warp (bitonic).
// A step's pairs are disjoint, so a lane loads up to four pairs before it
// stores any: four loads in flight instead of one.
__device__ void sort_desc(uint64_t* buf, int n, int lane) {
  constexpr int kPairs = 4;  // pairs a lane holds at once
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t0 = 0; t0 < n / 2; t0 += 32 * kPairs) {
        uint64_t a[kPairs], b[kPairs];
        int ix[kPairs];
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int t = t0 + lane + 32 * j;
          ix[j] = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
          if (t < n / 2) {
            a[j] = buf[ix[j]];
            b[j] = buf[ix[j] + stride];
          }
        }
#pragma unroll
        for (int j = 0; j < kPairs; ++j)
          if (t0 + lane + 32 * j < n / 2 &&
              (a[j] < b[j]) == ((ix[j] & size) == 0)) {
            buf[ix[j]] = b[j];
            buf[ix[j] + stride] = a[j];
          }
      }
      __syncwarp();
    }
}

// The least of buf[0, k) and its position, the same in every lane.
__device__ __forceinline__ void find_least(const uint64_t* buf, int k,
                                           int lane, uint64_t& w, int& wpos) {
  uint64_t m = ~0ull;
  int pos = 0;
  for (int i = lane; i < k; i += 32)
    if (buf[i] < m) {
      m = buf[i];
      pos = i;
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t mo = shfl64(m, lane ^ off);
    const int po = __shfl_xor_sync(0xffffffffu, pos, off);
    if (mo < m || (mo == m && po < pos)) {
      m = mo;
      pos = po;
    }
  }
  w = m;
  wpos = pos;
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 32;
  while (p < n) p <<= 1;
  return p;
}

// The survivors of buf[0, c) (entries whose key is >= tau) moved to its
// front, in order; returns their count. A chunk of 32 is read whole before
// any of it is written, and an entry only moves down.
__device__ int keep_at_least(uint64_t* buf, int c, uint32_t tau, int lane) {
  int kept = 0;
  for (int i0 = 0; i0 < c; i0 += 32) {
    const int i = i0 + lane;
    const uint64_t e = i < c ? buf[i] : 0ull;
    const bool keep = i < c && (uint32_t)(e >> 32) >= tau;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    __syncwarp();
    if (keep) buf[kept + __popc(m & ((1u << lane) - 1u))] = e;
    kept += __popc(m);
    __syncwarp();
  }
  return kept;
}

// The keys >= tau of keys[0, len) (rows row_base, ...) appended to buf at
// position c, as many as fit below cap; returns how many there are.
__device__ __forceinline__ int append_survivors(
    const uint32_t* __restrict__ keys, int n32, int row_base,
    uint64_t* __restrict__ buf, int c, int cap, uint32_t tau, int lane) {
  int n = 0;
#pragma unroll 4
  for (int i = 0; i < n32; ++i) {
    const uint32_t key = keys[lane + 32 * i];
    const bool s = key >= tau;
    const unsigned m = __ballot_sync(0xffffffffu, s);
    const int pos = c + n + __popc(m & ((1u << lane) - 1u));
    if (s && pos < cap) buf[pos] = pack(key, row_base + lane + 32 * i);
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// One warp's selection over one segment of a group: keys[0, len) of rows
// row_base, ... join the candidates buf[0, c) of the group's earlier
// segments, a superset of their rows' first k; returns the new count.
//   1. τ, a lower bound of the k-th best score of the group's rows so far:
//      the k-th largest of 256 block maxima (block j of lane l: its rows
//      l + 32i with i % 8 = j, over every segment so far, kept in ``mk``),
//      to its kTauBits leading bits, found bit by bit with a warp sum of the
//      counts. k blocks each hold a key >= it, so the k-th best is too. For
//      k > 256 the blocks are the segment's single rows. τ only rises.
//      Fewer than k rows: τ = 1, and every row takes part.
//   2. The segment's rows >= τ (the survivors) go after the candidates by
//      ballot and prefix. If they do not fit the buffer's ``cap``, the
//      candidates below τ are dropped first and the survivors appended
//      again.
//   3. If they still do not fit (ties at τ, or k > 256 on a long segment):
//      the candidates, sorted, give their first k to a k-entry buffer, and
//      the scan kernels' buffer insertion takes the survivors, each better
//      than the buffer's least entry replacing it. ``overflows`` counts
//      these.
// The caller keeps the candidates >= the last τ and sorts them.
__device__ __forceinline__ int select_segment(
    const uint32_t* __restrict__ keys, int len, int row_base,
    uint64_t* __restrict__ buf, int c, int k, int cap, int lane,
    uint32_t (&mk)[kLaneBlocks], uint32_t& tau, int* overflows) {
  const int n32 = (len + 31) / 32;
  uint32_t t = 0u;
  if (k <= 32 * kLaneBlocks) {
    for (int i0 = 0; i0 < n32; i0 += kLaneBlocks)
#pragma unroll
      for (int j = 0; j < kLaneBlocks; ++j)
        if (i0 + j < n32) mk[j] = max(mk[j], keys[lane + 32 * (i0 + j)]);
#pragma unroll 1
    for (int b = 31; b >= 32 - kTauBits; --b) {
      const uint32_t cand = t | (1u << b);
      int n = 0;
#pragma unroll
      for (int j = 0; j < kLaneBlocks; ++j) n += mk[j] >= cand;
      if ((int)__reduce_add_sync(0xffffffffu, (unsigned)n) >= k) t = cand;
    }
  } else {
#pragma unroll 1
    for (int b = 31; b >= 32 - kTauBits; --b) {
      const uint32_t cand = t | (1u << b);
      int n = 0;
      for (int i = 0; i < n32; ++i) n += keys[lane + 32 * i] >= cand;
      if ((int)__reduce_add_sync(0xffffffffu, (unsigned)n) >= k) t = cand;
    }
  }
  tau = max(tau, max(t, 1u));

  int n = append_survivors(keys, n32, row_base, buf, c, cap, tau, lane);
  if (c + n <= cap) return c + n;
  c = keep_at_least(buf, c, tau, lane);
  if (c + n <= cap) {
    append_survivors(keys, n32, row_base, buf, c, cap, tau, lane);
    return c + n;
  }

  if (lane == 0 && overflows) atomicAdd(overflows, 1);
  const int p = pow2_at_least(c);
  for (int i = c + lane; i < p; i += 32) buf[i] = 0ull;
  __syncwarp();
  sort_desc(buf, p, lane);
  for (int i = min(k, c) + lane; i < k; i += 32) buf[i] = 0ull;
  __syncwarp();
  uint64_t w;
  int wpos;
  find_least(buf, k, lane, w, wpos);
  for (int i = 0; i < n32; ++i) {
    const uint32_t key = keys[lane + 32 * i];
    const uint64_t e = key >= tau ? pack(key, row_base + lane + 32 * i) : 0ull;
    unsigned m = __ballot_sync(0xffffffffu, e > w);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const uint64_t ce = shfl64(e, src);
      if (ce > w) {  // the least may have risen since
        if (lane == 0) buf[wpos] = ce;
        __syncwarp();
        find_least(buf, k, lane, w, wpos);
      }
    }
  }
  return min(k, min(k, c) + n);
}

// This thread's 16 bytes of each row of the segment at group row s0: rows
// past the group read as zeros (their keys are 0)
__device__ __forceinline__ void load_segment(float4 (&v)[kSegLoads],
                                             const float* src, int s0,
                                             int group, int ld) {
#pragma unroll
  for (int i = 0; i < kSegLoads; ++i) {
    const int row = s0 + (threadIdx.x >> 1) + i * (kSelThreads / 2);
    v[i] = row < group ? __ldg(reinterpret_cast<const float4*>(
                             src + (size_t)row * ld))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One CTA: group blockIdx.y of the chunk against queries [qt, qt + 8) of it,
// qt = 8 blockIdx.x: the query tiles of a group are neighbours in the grid,
// so the CTAs that read the 32-byte pieces of one group's Sᵀ rows run
// together and the rows come from memory once. Sᵀ is (rows, ld) f32: chunk row r is database row row0
// + r, column q is query q0 + q (columns >= qc: padding queries, never
// selected). The group goes through shared memory in segments of kSegRows
// rows, as keys, query-major: thread t moves 16 bytes of each segment row
// (t / 2 + 128 i), queries 4 (t % 2) .. + 3, one segment ahead of the
// selection. Warp w selects for query qt + w in its buffer of ``cap``
// entries; at the end the candidates >= τ are sorted once and the group's
// first k leave sorted, empty entries as (-inf, row 0).
__global__ void __launch_bounds__(kSelThreads, 2)
topk_select_kernel(const float* __restrict__ st, int ld, int row0,
                   int n_valid, int k, int group, int qc, int cap,
                   float* __restrict__ out_s, int* __restrict__ out_r, int Q,
                   int q0, int* __restrict__ overflows) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);  // (8, kSegStride)
  uint64_t* cand = reinterpret_cast<uint64_t*>(keys + kSelQ * kSegStride);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x * kSelQ, half = tid & 1;
  const size_t first = (size_t)blockIdx.y * group;  // the group's chunk row
  const float* src = st + first * ld + qt + 4 * half;
  // group rows [0, valid_end) are < n_valid
  const long long valid_end = (long long)n_valid - row0 - (long long)first;
  const bool selects = qt + warp < qc;
  uint64_t* buf = cand + (size_t)warp * cap;
  int c = 0;              // the warp's candidates in buf
  uint32_t tau = 0u;      // its lower bound
  uint32_t mk[kLaneBlocks];  // its lane's block maxima
#pragma unroll
  for (int j = 0; j < kLaneBlocks; ++j) mk[j] = 0u;

  float4 v[kSegLoads];
  load_segment(v, src, 0, group, ld);
  for (int s0 = 0; s0 < group; s0 += kSegRows) {
#pragma unroll
    for (int i = 0; i < kSegLoads; ++i) {
      const int r = (tid >> 1) + i * (kSelThreads / 2), row = s0 + r;
      const bool valid = row < group && row < valid_end;
      uint32_t* d = keys + 4 * half * kSegStride + r;
      d[0] = valid ? score_key(v[i].x) : 0u;
      d[kSegStride] = valid ? score_key(v[i].y) : 0u;
      d[2 * kSegStride] = valid ? score_key(v[i].z) : 0u;
      d[3 * kSegStride] = valid ? score_key(v[i].w) : 0u;
    }
    __syncthreads();
    if (s0 + kSegRows < group) load_segment(v, src, s0 + kSegRows, group, ld);
    if (selects)
      c = select_segment(keys + warp * kSegStride, min(kSegRows, group - s0),
                         row0 + (int)first + s0, buf, c, k, cap, lane, mk,
                         tau, overflows);
    __syncthreads();
  }

  if (!selects) return;
  c = keep_at_least(buf, c, tau, lane);
  const int p = pow2_at_least(c);
  for (int i = c + lane; i < p; i += 32) buf[i] = 0ull;
  __syncwarp();
  sort_desc(buf, p, lane);
  c = min(k, c);
  const size_t o =
      (((size_t)row0 / group + blockIdx.y) * Q + q0 + qt + warp) * k;
  for (int j = lane; j < k; j += 32) {
    const uint64_t e = buf[j];
    out_s[o + j] = j < c ? key_score((uint32_t)(e >> 32)) : -INFINITY;
    out_r[o + j] = j < c ? (int)~(uint32_t)e : 0;
  }
}

}  // namespace

extern "C" {

// The running top-k with the threshold skip: each CTA carries its buffer
// over ``span_groups`` groups of ``group`` rows. out (spans, Q, k).
int wt_topk_threshold(const float* queries, const void* db, int bf16_db,
                      float* out_s, int* out_r, int Q, int D, int n_rows,
                      int n_valid, int k, int group, int span_groups,
                      void* stream) {
  if (group < 1 || span_groups < 1 || n_rows % group ||
      (long long)group * span_groups > INT_MAX)
    return (int)cudaErrorInvalidValue;
  return (int)launch(queries, db, bf16_db, out_s, out_r, Q, D, n_rows,
                     n_valid, k, group * span_groups,
                     static_cast<cudaStream_t>(stream));
}

// The bf16 group path's product: Sᵀ (rows, q_pad) f32 = db (rows, D) bf16,
// the rows as they lie, times wq (D, q_pad) bf16 = bf16(queries)ᵀ, on
// common.cuh's GEMM with no bias (its epilogue adds none where bias is
// null). q_pad % 8 == 0 (TMA's 16-byte row stride).
int wt_topk_gemm(const void* db, int rows, int D, const void* wq, int q_pad,
                 float* out, void* stream) {
  if (rows < 1 || D < 8 || D % 8 || q_pad < 8 || q_pad % 8)
    return (int)cudaErrorInvalidValue;
  return (int)gemm<float, kBias>(
      static_cast<const bf16*>(db), D, static_cast<const bf16*>(wq), q_pad,
      nullptr, out, q_pad, nullptr, 0, kNoMap, rows, q_pad, D, kNone,
      static_cast<cudaStream_t>(stream));
}

// The f32 group path's product: Sᵀ (rows, q_pad) f32 = db (rows, D) f32,
// the rows as they lie, against the queries split into TF32 halves: qs (2,
// q_pad, d_pad) f32 = (q_hi, q_lo), d_pad = D rounded up to 32, each
// 32-column block's columns in the kernel's fragment order (ops/fused_topk.py
// tf32_split). S = hi(db) q_hi + hi(db) q_lo + lo(db) q_hi, summed in f32.
// q_pad % 8 == 0, q_pad <= 64.
int wt_topk_gemm_f32(const float* db, int rows, int D, const float* qs,
                     int q_pad, int d_pad, float* out, void* stream) {
  if (rows < 1 || D < 4 || D % 4 || d_pad < D || d_pad % kF32BK ||
      d_pad - D >= kF32BK || q_pad < 8 || q_pad % 8 || q_pad > kF32BN ||
      !aligned(out, 8))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_db, map_q;
  WT_CHECK(tile_map<float>(&map_db, db, rows, D, D, kF32BM, kF32BK));
  WT_CHECK(tile_map<float>(&map_q, qs, 2 * q_pad, d_pad, d_pad, kF32BN,
                           kF32BK));
  static const cudaError_t attr = cudaFuncSetAttribute(
      topk_gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kF32Smem);
  WT_CHECK(attr);
  const int tiles = (rows + kF32BM - 1) / kF32BM;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  topk_gemm_f32_kernel<<<grid, kF32Threads, kF32Smem,
                         static_cast<cudaStream_t>(stream)>>>(
      map_db, map_q, out, rows, q_pad, D);
  return (int)cudaGetLastError();
}

// The group selection of both storage types: Sᵀ (rows, ld) f32 of database
// rows [row0, row0 + rows), whole groups, against queries [q0, q0 + qc)
// (columns [0, qc) of Sᵀ) -> slots row0 / group .. of out (groups, Q, k):
// each group's first k by (score descending, row ascending), sorted, rows
// >= n_valid left out, a group with fewer than k valid rows filled with
// (-inf, 0). One CTA per (tile of 8 queries, group). ``overflows`` (one
// device int, or null) counts the (query, segment) selections that took the
// buffer insertion.
int wt_topk_select(const float* st, int ld, int rows, int row0, int n_valid,
                   int k, int group, int qc, float* out_s, int* out_r, int Q,
                   int q0, int* overflows, void* stream) {
  if (ld < 8 || ld % 8 || qc < 1 || qc > ld || group < 1 || rows < group ||
      rows % group || row0 < 0 || row0 % group || n_valid < 0 || k < 1 ||
      k > group || k > 1024 || q0 < 0 || q0 + qc > Q ||
      rows / group > 65535 || !aligned(st, 16))
    return (int)cudaErrorInvalidValue;
  int cap = 512;  // entries a query's buffer holds: 2k at the least
  while (cap < 2 * k) cap <<= 1;
  const size_t smem =
      (size_t)kSelQ * kSegStride * 4 + (size_t)kSelQ * cap * 8;
  cudaError_t err = cudaFuncSetAttribute(
      topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((qc + kSelQ - 1) / kSelQ, rows / group);
  topk_select_kernel<<<grid, kSelThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      st, ld, row0, n_valid, k, group, qc, cap, out_s, out_r, Q, q0,
      overflows);
  return (int)cudaGetLastError();
}

}  // extern "C"
