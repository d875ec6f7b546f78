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
// 1. pallas_topk on bf16 storage (wt_topk_gemm + wt_topk_select, the
//    batched search's path). At 1,048,576 x 512 bf16 the bound is the
//    database read, 1.07 GB at 3.35 TB/s = 0.32 ms, plus the Sᵀ scratch
//    below, 256 MB written and read again at Q = 64 (0.16 ms more). The
//    design reads the database once for up to 64 queries on the tensor
//    cores: the wrapper (ops/fused_topk.py group_topk_chunks) cuts the work
//    into chunks of whole groups by at most 64 queries, and for each chunk
//      - wt_topk_gemm runs the port's GEMM (common.cuh gemm_kernel: TMA +
//        wgmma, f32 accumulators, bias-free epilogue) on A = the chunk's
//        database rows as they lie, W = bf16(q)ᵀ (D, Q_pad), into Sᵀ (rows,
//        Q_pad) f32: bf16 products are exact in f32 and the sums stay f32;
//      - wt_topk_select (topk_select_kernel) gives one CTA to each (group,
//        tile of 8 queries): it streams the group's Sᵀ rows (32 contiguous
//        bytes a row and query tile, one sector) through registers into
//        shared memory, one tile ahead, sets rows >= n_valid to -inf and
//        runs the selection below, unchanged.
//    The next step is the selection fused into the GEMM's epilogue, which
//    drops the Sᵀ round trip. The selection's own work holds the call,
//    though (2.2-2.3 of 3.2 ms at Q = 64, k = 100 on an H100 80GB HBM3:
//    ~471 buffer insertions per query and group, each a find_worst), so
//    fewer insertions come first.
//
// 2. pallas_topk on f32 storage (wt_topk_group) and pallas_topk_threshold
//    (wt_topk_threshold): f32 storage scores in full f32 (no TF32, which
//    wgmma would need), so these scan with scalar FMAs. The TPU kernel
//    walks the groups one after another on one core with one running
//    buffer. Here the grid is (query tiles, row spans): a CTA owns a
//    contiguous span of rows and a tile of up to 8 queries held in shared
//    memory, streams its rows in tiles of kTile, and keeps its span's
//    running top-k per query in shared memory.
//      scoring: a warp takes kRows rows at a time; its lanes read the rows
//        in 16-byte pieces (neighbouring lanes, neighbouring addresses) and
//        multiply them with the queries from shared memory: f32 FMAs; bf16
//        storage (the threshold kernel's) meets the query rounded to bf16,
//        products and sums in f32. The partial sums of the kRows x QT
//        accumulators are reduced across the warp by a butterfly that
//        halves the accumulators at each step. Rows >= n_valid (zero
//        padding, which would outscore negative true scores) and rows past
//        the span become -inf before any selection.
//    wt_topk_threshold gives each CTA a span of whole groups, sized by the
//    caller so that the grid fills the card. wt_topk_group gives each CTA
//    one group: every group's own top-k, no carry from group to group.
//
// The selection (select_tile), shared by both: warp q owns query q's
// buffer, (score, row) pairs, unsorted, with the worst entry (lowest score,
// on ties the highest row) known. A tile's scores are compared with the
// worst entry: where none is better (a ballot) the 32 rows are skipped,
// which is the threshold skip. A better candidate replaces the worst entry,
// and the worst is found anew (k / 32 entries a lane and a warp reduction).
// "Better" is the total order (score descending, row ascending), so the
// buffer holds the first k in that order whatever the order of insertion:
// the one intended difference from the TPU threshold kernel, which evicts
// the first lane among tied worsts. Nothing carries over between CTAs: each
// writes its k candidates, and the wrapper merges the (slots, Q, k)
// candidates with torch ops, as the merge is outside both Pallas kernels.

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
// The bf16 group path's selection: Sᵀ (from wt_topk_gemm) -> each group's
// top-k of each query
// ---------------------------------------------------------------------------

constexpr int kSelTile = 256;  // Sᵀ rows a selection tile holds
// a query's row of the tile in shared memory; the pad of 4 floats puts the
// two halves of a row's 8 scores 16 banks apart, so the transposing stores
// meet no bank twice
constexpr int kSelStride = kSelTile + 4;
// 16-byte loads a thread makes for a tile (4 scores of one row each)
constexpr int kSelLoads = kSelTile * kMaxQT / 4 / kThreads;

// This thread's 16 bytes of each row of the tile at group row tile0; rows
// past the group read as zeros (masked when stored)
__device__ __forceinline__ void load_tile(float4 (&v)[kSelLoads],
                                          const float* src, int tile0,
                                          int group, int ld) {
#pragma unroll
  for (int i = 0; i < kSelLoads; ++i) {
    const int row = tile0 + (threadIdx.x >> 1) + i * (kThreads / 2);
    v[i] = row < group ? __ldg(reinterpret_cast<const float4*>(
                             src + (size_t)row * ld))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One CTA: group blockIdx.x of the chunk against queries [qt, qt + 8) of it,
// qt = 8 blockIdx.y. Sᵀ is (rows, ld) f32: chunk row r is database row
// row0 + r, column q is query q0 + q (columns >= qc: padding queries, never
// selected). Thread t moves 16 bytes of each tile row (t / 2 + 128 i):
// queries qt + 4 (t % 2) .. + 3, one tile ahead of the selection.
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float* __restrict__ st, int ld, int row0,
                   int n_valid, int k, int group, int qc,
                   float* __restrict__ out_s, int* __restrict__ out_r, int Q,
                   int q0) {
  constexpr int QT = kMaxQT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);     // (QT, kSelStride) scores
  float* bs = sc + QT * kSelStride;               // (QT, k) buffer scores
  int* br = reinterpret_cast<int*>(bs + QT * k);  // (QT, k) buffer rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.y * QT, half = tid & 1;
  const size_t first = (size_t)blockIdx.x * group;  // the group's chunk row
  const float* src = st + first * ld + qt + 4 * half;
  for (int i = tid; i < QT * k; i += kThreads) {
    bs[i] = -INFINITY;
    br[i] = INT_MAX;  // an empty slot: worse than every row
  }

  const bool selects = qt + warp < qc;
  float ws = -INFINITY;
  int wr = INT_MAX, wpos = 0;
  float* my_bs = bs + warp * k;
  int* my_br = br + warp * k;

  float4 v[kSelLoads];
  load_tile(v, src, 0, group, ld);
  for (int tile0 = 0; tile0 < group; tile0 += kSelTile) {
#pragma unroll
    for (int i = 0; i < kSelLoads; ++i) {
      const int r = (tid >> 1) + i * (kThreads / 2), row = tile0 + r;
      const bool valid = row < group && row0 + (long long)first + row <
                                            (long long)n_valid;
      float* d = sc + 4 * half * kSelStride + r;
      d[0] = valid ? v[i].x : -INFINITY;
      d[kSelStride] = valid ? v[i].y : -INFINITY;
      d[2 * kSelStride] = valid ? v[i].z : -INFINITY;
      d[3 * kSelStride] = valid ? v[i].w : -INFINITY;
    }
    __syncthreads();
    if (tile0 + kSelTile < group)
      load_tile(v, src, tile0 + kSelTile, group, ld);
    if (selects)
      select_tile<kSelTile>(sc + warp * kSelStride, row0 + (int)first + tile0,
                            k, lane, my_bs, my_br, ws, wr, wpos);
    __syncthreads();
  }

  const size_t slot = (size_t)row0 / group + blockIdx.x;
  for (int i = tid; i < QT * k; i += kThreads) {
    const int q = qt + i / k;
    if (q >= qc) continue;
    const size_t o = (slot * Q + q0 + q) * k + i % k;
    out_s[o] = bs[i];
    out_r[o] = br[i] == INT_MAX ? 0 : br[i];  // an empty slot: (-inf, row 0)
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

// Each group's own top-k, one CTA per (group, query tile), no carry from
// group to group. out (n_rows / group, Q, k); k <= group.
int wt_topk_group(const float* queries, const void* db, int bf16_db,
                  float* out_s, int* out_r, int Q, int D, int n_rows,
                  int n_valid, int k, int group, void* stream) {
  if (group < 1 || n_rows % group || k > group)
    return (int)cudaErrorInvalidValue;
  return (int)launch(queries, db, bf16_db, out_s, out_r, Q, D, n_rows,
                     n_valid, k, group, static_cast<cudaStream_t>(stream));
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

// The bf16 group path's selection: Sᵀ (rows, ld) f32 of database rows
// [row0, row0 + rows), whole groups, against queries [q0, q0 + qc) (columns
// [0, qc) of Sᵀ) -> slots row0 / group .. of out (groups, Q, k): each
// group's first k by (score descending, row ascending), unsorted, rows >=
// n_valid left out, a group with fewer than k valid rows filled with (-inf,
// 0). One CTA per (group, tile of 8 queries).
int wt_topk_select(const float* st, int ld, int rows, int row0, int n_valid,
                   int k, int group, int qc, float* out_s, int* out_r, int Q,
                   int q0, void* stream) {
  if (ld < 8 || ld % 8 || qc < 1 || qc > ld || group < 1 || rows < group ||
      rows % group || row0 < 0 || row0 % group || n_valid < 0 || k < 1 ||
      k > group || k > 1024 || q0 < 0 || q0 + qc > Q || qc > 8 * 65535 ||
      !aligned(st, 16))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)kMaxQT * kSelStride + 2 * (size_t)kMaxQT * k) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(rows / group, (qc + kMaxQT - 1) / kMaxQT);
  topk_select_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      st, ld, row0, n_valid, k, group, qc, out_s, out_r, Q, q0);
  return (int)cudaGetLastError();
}

}  // extern "C"
