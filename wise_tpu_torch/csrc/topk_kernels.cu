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
// 2. pallas_topk_threshold (wt_topk_threshold, topk_scan_kernel): the
//    served query's path (Q = 1, and small coalesced batches). f32 storage
//    scores in full f32 (scalar FMAs); bf16 storage meets the query rounded
//    to bf16, products exact, sums f32. The TPU kernel walks the groups one
//    after another on one core with one running buffer. Here one persistent
//    CTA an SM owns a contiguous range of whole 256-row blocks
//    (a range may start and end inside a group, which is only the padding
//    contract) and a tile of 1, 8 or 16 queries, so that a batch of up to 16
//    reads the database once (ops/fused_topk.py scan_plan chooses the
//    ranges, the tile and the lists' size):
//      streaming: one producer thread keeps a ring of 32 KB stages in flight
//        with 2-D TMA loads (cp.async.bulk.tensor) and mbarriers; a stage is
//        256 rows x 128 bytes (32 f32 or 64 bf16 columns) under the 128-byte
//        swizzle, and a block of rows takes D * itemsize / 128 stages, as a
//        GEMM's K loop does. No barrier across the CTA stops the producer:
//        each consumer warp arrives on a stage's empty barrier once it has
//        read it.
//      scoring: lane l of consumer warp w owns row 32 w + l of every stage.
//        Scalar (one query, on either storage type): the lane reads
//        its row's 16-byte chunk j at chunk j ^ (l % 8) (the swizzle: the 8
//        lanes of a quarter warp meet 8 bank groups), and the queries' same
//        columns are broadcast reads from shared memory; f32 FMAs into
//        partials a stage, added to the row's sums once the stage is read.
//        f32 storage at 8 or 16 queries blocks the same FMAs 4 rows x Q / 4
//        queries a lane, which halves the shared-memory reads a FMA.
//        Tensor cores (bf16 storage at 8 or 16 queries, where scalar FMAs
//        and their query reads would hold the scan): the warp's 32 rows are
//        two m16 tiles, read by ldmatrix from the swizzled stage, against
//        the queries as bf16 n8 tiles, mma.sync m16n8k16 from zero each k16
//        step, each result added to f32 sums; a score buffer in shared
//        memory turns the fragments (and the blocked sums) back into a row
//        a lane.
//      selection, off the scan's critical path: each query has a threshold
//        τ, the k-th best (score key, ~row) word its list has kept (0 until
//        k are kept), and a list of p entries: k kept, then p - k candidates
//        (p a power of two >= max(128, k + max(k, 32))). Once a row block
//        is scored, a warp compares its 32 rows' words with τ, one vote a
//        query; the rare warp with a survivor takes the query's lock, appends
//        its survivors behind the kept entries with one ballot and prefix,
//        and when they would pass the list's capacity first reduces the list
//        to its first k by one bitonic sort of the words (a flush, counted in
//        ``flushes``), which raises τ. The word orders by (score
//        descending, row ascending), so ties at τ keep the lower row, and a
//        CTA's range of R rows admits about k + k ln(R / k) survivors.
//      merge: each CTA writes its range's first k of each query, sorted, to
//        the (ranges, Q, k) candidates, fences them and takes a ticket (the
//        call's, zeroed before the launch); the last CTA of a query tile
//        filters the ranges' lists through the same lists, a lane a range
//        and all its warps at once, τ starting just under the largest of the
//        ranges' k-th words (each a lower bound of the k-th best; a range's
//        list stops at its first entry under τ), and writes the (Q, k)
//        answer, so that the call is one launch (a merge in torch ops took
//        0.11-0.19 ms of host-bound launches a call on an H100, against
//        ~0.69 ms of scan at Q = 1).
//    At 1,048,576 x 512 the bound is the database read (2.15 GB f32 in 0.64
//    ms; 1.07 GB bf16 in 0.32 ms); Q = 16 f32 needs 26.8 TFLOP/s of FMAs
//    beside it.
#include "common.cuh"

namespace {

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
//      a buffer insertion takes the survivors, each better
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


// ---------------------------------------------------------------------------
// The served query's scan (wt_topk_threshold): a persistent CTA a range of
// rows streamed through a TMA ring, each row scored against up to 16 queries,
// the selection by filter, append and flush, and the ranges' merge by the
// last CTA of a query tile
// ---------------------------------------------------------------------------

constexpr int kScanWarps = 8;                       // consumer warps
constexpr int kScanThreads = 32 * kScanWarps + 32;  // + the producer warp
constexpr int kScanRows = 32 * kScanWarps;  // a stage's rows: a lane a row
constexpr int kScanStageBytes = kScanRows * kSwzRowBytes;  // 32 KB
constexpr int kScanMaxStages = 6;
constexpr int kScanMinStages = 3;
constexpr int kScanMaxQT = 16;        // queries a CTA scores on one read
constexpr int kScanMaxD = 1280;       // widest rows: ViT-bigG-14's embed_dim
constexpr int kScanSmemMax = 232448;  // a block's most shared memory

// How a query tile scores: on the tensor cores for bf16 storage at 8 or 16
// queries (mma.sync m16n8k16: bf16 products are exact in f32), with scalar
// FMAs blocked 4 rows x QT / 4 queries a lane for f32 storage there, else a
// lane a row. Both tiles of 8 or 16 turn their sums back into a row a lane
// through a score buffer.
__host__ __device__ constexpr bool scan_mma(bool bf16_db, int qt) {
  return bf16_db && qt >= 8;
}
__host__ __device__ constexpr bool scan_buffered(int qt) { return qt >= 8; }

// Bytes of the queries in shared memory: f32 (qt, dp), or on the tensor
// cores bf16 (qt, dp + 8) (the pad puts the 8 rows an ldmatrix reads in 8
// bank groups); and of the score buffer: (32 rows, qt + 1) f32 a consumer
// warp.
__host__ __device__ constexpr int scan_q_bytes(bool mma, int qt, int dp) {
  return mma ? qt * (dp + 8) * 2 : qt * dp * 4;
}
__host__ __device__ constexpr int scan_sb_bytes(int qt) {
  return scan_buffered(qt) ? kScanWarps * 32 * (qt + 1) * 4 : 0;
}

// The scan's dynamic shared memory: room to align the ring to the swizzle
// atom, the ring and its two barriers a stage, the queries, the score
// buffer, and each query's list of p words, τ, count and lock, and the
// last-CTA flag.
size_t scan_smem(bool mma, int qt, int stages, int dp, int p) {
  return (size_t)kSwzAtomBytes + (size_t)stages * (kScanStageBytes + 16) +
         scan_q_bytes(mma, qt, dp) + scan_sb_bytes(qt) +
         (size_t)qt * p * 8 + (size_t)qt * 16 + 16;
}

// Sort lst[0, p) descending, p a power of two >= 128, by one warp (bitonic),
// after zeroing lst[used, p) (0 is the empty entry, worse than every row).
// The scan's own copy of sort_desc, so that the group selection compiles as
// it did.
__device__ __noinline__ void scan_sort(uint64_t* lst, int used, int p,
                                       int lane) {
  constexpr int kPairs = 4;  // pairs a lane holds at once
  for (int i = used + lane; i < p; i += 32) lst[i] = 0ull;
  __syncwarp();
  for (int size = 2; size <= p; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t0 = 0; t0 < p / 2; t0 += 32 * kPairs) {
        uint64_t a[kPairs], b[kPairs];
        int ix[kPairs];
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int t = t0 + lane + 32 * j;
          ix[j] = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
          if (t < p / 2) {
            a[j] = lst[ix[j]];
            b[j] = lst[ix[j] + stride];
          }
        }
#pragma unroll
        for (int j = 0; j < kPairs; ++j)
          if (t0 + lane + 32 * j < p / 2 &&
              (a[j] < b[j]) == ((ix[j] & size) == 0)) {
            lst[ix[j]] = b[j];
            lst[ix[j] + stride] = a[j];
          }
      }
      __syncwarp();
    }
}

// One warp's survivors of a query's filter (``key`` > τ, 0 for a lane
// without one) into the query's list lst: kept entries [0, k), candidates
// [k, k + cnt), room for ``cap`` candidates. Under the query's lock, since
// every consumer warp appends to it. Survivors that would pass the capacity
// first flush the list: one sort keeps its first k, and τ rises to the k-th.
__device__ __noinline__ void scan_append(uint64_t key, uint64_t* lst,
                                         volatile uint64_t* tau,
                                         volatile int* cnt, int* lock, int k,
                                         int cap, int p, int lane,
                                         int* flushes) {
  if (lane == 0)
    while (atomicCAS(lock, 0, 1) != 0) __nanosleep(32);
  __syncwarp();
  __threadfence_block();
  uint64_t t = *tau;  // τ may have risen since the vote
  int n = *cnt;
  unsigned m = __ballot_sync(0xffffffffu, key > t);
  if (n + __popc(m) > cap) {
    scan_sort(lst, k + n, p, lane);
    t = lst[k - 1];
    n = 0;
    m = __ballot_sync(0xffffffffu, key > t);  // at most 32 <= cap
    if (lane == 0) {
      *tau = t;
      if (flushes) atomicAdd(flushes, 1);
    }
  }
  if (key > t) lst[k + n + __popc(m & ((1u << lane) - 1u))] = key;
  if (lane == 0) *cnt = n + __popc(m);
  __threadfence_block();
  __syncwarp();
  if (lane == 0) atomicExch(lock, 0);
}

// Scalar scoring: this lane's row of one stage (its 128-byte line ``row``,
// chunk j at j ^ sw) against the QT queries' same columns (sqk: (QT, 128
// bytes' columns) f32, one broadcast read a chunk and query), into ``part``.
template <typename T, int QT>
__device__ __forceinline__ void score_stage(const unsigned char* row, int sw,
                                            const float* sqk,
                                            float (&part)[QT]) {
  constexpr int kCols = kSwzRowBytes / sizeof(T);  // 32 f32, 64 bf16
  constexpr int E = 16 / sizeof(T);                // columns of a chunk
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 t = reinterpret_cast<const uint4*>(row)[j ^ sw];
    float x[8];
    if constexpr (sizeof(T) == 4) {
      x[0] = __uint_as_float(t.x);
      x[1] = __uint_as_float(t.y);
      x[2] = __uint_as_float(t.z);
      x[3] = __uint_as_float(t.w);
    } else {  // a bf16 is the high half of an f32
      const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
#pragma unroll
    for (int q = 0; q < QT; ++q) {
#pragma unroll
      for (int h = 0; h < E / 4; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(sqk + q * kCols + E * j + 4 * h);
        float a = part[q];
        a = fmaf(x[4 * h], v.x, a);
        a = fmaf(x[4 * h + 1], v.y, a);
        a = fmaf(x[4 * h + 2], v.z, a);
        a = fmaf(x[4 * h + 3], v.w, a);
        part[q] = a;
      }
    }
  }
}

// Blocked scalar scoring of one f32 stage (QT = 8 or 16): lane (u = lane /
// 8, v = lane % 8) scores the warp's rows v + 8 i, i < 4, against queries
// QT / 4 u .. + QT / 4 - 1. A chunk's 4 row reads (chunk j of each at j ^ v:
// 8 bank groups a quarter warp) and QT / 4 query reads (one address a
// quarter warp: broadcasts) feed 16 QT / 4 FMAs, half the reads a FMA of
// the lane-a-row form. part[i][g]: row v + 8 i, query QT / 4 u + g.
template <int QT>
__device__ __forceinline__ void score_stage_blocked(
    const unsigned char* stage, int warp, int lane, const float* sqk,
    float (&part)[4][QT / 4]) {
  constexpr int QG = QT / 4;
  const int u = lane >> 3, v = lane & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = reinterpret_cast<const float4*>(
          stage + (warp * 32 + v + 8 * i) * kSwzRowBytes)[j ^ v];
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      const float4 w =
          *reinterpret_cast<const float4*>(sqk + (QG * u + g) * 32 + 4 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = part[i][g];
        a = fmaf(x[i].x, w.x, a);
        a = fmaf(x[i].y, w.y, a);
        a = fmaf(x[i].z, w.z, a);
        a = fmaf(x[i].w, w.w, a);
        part[i][g] = a;
      }
    }
  }
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8
__device__ __forceinline__ void scan_ldsm_x4(uint32_t (&r)[4],
                                             uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16x8 f32) = a (16x16 bf16, row) b (16x8 bf16, col), from zero: the
// products exact, their sum the tensor core's, added to the f32 sums outside
__device__ __forceinline__ void scan_mma16(float (&d)[4],
                                           const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Tensor-core scoring of one bf16 stage (64 columns, 4 k16 steps) for this
// warp's 32 rows (two m16 tiles) against NT = QT / 8 n8 tiles of queries:
// acc[m][n][e] += row 16 m + g + 8 (e / 2), query 8 n + 2 t + e % 2 (g =
// lane / 4, t = lane % 4). ``stage`` is the stage's shared address, ``sqb``
// the queries' (bf16 (QT, dq), dq = dp + 8) at this stage's first column.
template <int QT>
__device__ __forceinline__ void score_stage_mma(uint32_t stage, int warp,
                                                int lane, uint32_t sqb, int dq,
                                                float (&acc)[2][QT / 8][4]) {
  constexpr int NT = QT / 8;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      // row lane % 16 of the m16 tile, 16-byte chunk 2 s + lane / 16
      const int r = warp * 32 + m * 16 + (lane & 15);
      const int c = (2 * s + (lane >> 4)) ^ (r & 7);
      scan_ldsm_x4(a[m], stage + r * kSwzRowBytes + (c << 4));
    }
    uint32_t b[NT][2];
    if constexpr (NT == 2) {
      // query (lane & 7) + 8 (lane / 16), k offset 8 ((lane / 8) & 1)
      uint32_t r4[4];
      scan_ldsm_x4(r4, sqb + (((lane & 7) + ((lane >> 4) << 3)) * dq +
                              16 * s + ((lane >> 3) & 1) * 8) * 2);
      b[0][0] = r4[0]; b[0][1] = r4[1];
      b[1][0] = r4[2]; b[1][1] = r4[3];
    } else {
      // query lane & 7, k offset 8 ((lane / 8) & 1) (lanes 16-31 the same)
      uint32_t r4[4];
      scan_ldsm_x4(r4, sqb + ((lane & 7) * dq + 16 * s +
                              ((lane >> 3) & 1) * 8) * 2);
      b[0][0] = r4[0]; b[0][1] = r4[1];
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float d[4];
        scan_mma16(d, a[m], b[n][0], b[n][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += d[e];
      }
  }
}

// The vote of one query's word ``key`` (0 for a lane without a row) against
// its τ, and the append of the survivors.
__device__ __forceinline__ void scan_vote(uint64_t key, int q, uint64_t* lists,
                                          uint64_t* taus, int* cnts,
                                          int* locks, int k, int cap, int p,
                                          int lane, int* flushes) {
  const uint64_t t = *static_cast<volatile uint64_t*>(taus + q);
  if (__any_sync(0xffffffffu, key > t))
    scan_append(key, lists + q * p, taus + q, cnts + q, locks + q, k, cap, p,
                lane, flushes);
}

// One CTA: queries [q0, q0 + QT), q0 = QT blockIdx.y, against the row blocks
// of range blockIdx.x (blocks of kScanRows rows, split evenly over
// ``ranges``) -> slot blockIdx.x of the candidates (ranges, Q, k): the
// range's first k of each query by (score descending, row ascending),
// sorted, empty entries as (-inf, row 0). With top_s, the last CTA of the
// query tile to finish (a ticket after a fence) merges the ranges'
// candidates by the same filter and flush into top_s / top_r (Q, k). Warps
// [0, kScanWarps) consume, the last warp produces.
// Shared memory: the ring (``stages`` x 32 KB, 1024-aligned), full and empty
// barriers, the queries (scalar: (dp / cols, QT, cols) f32, a stage's
// columns of every query together; tensor cores: bf16 (QT, dp + 8)), the
// score buffer, the lists, τ, counts, locks and the last-CTA flag.
template <typename T, int QT>
__global__ void __launch_bounds__(kScanThreads, 1)
topk_scan_kernel(const __grid_constant__ CUtensorMap tma_db,
                 const float* __restrict__ queries, float* __restrict__ out_s,
                 int* __restrict__ out_r, float* __restrict__ top_s,
                 long long* __restrict__ top_r, int* __restrict__ tickets,
                 int Q, int D, int n_rows, int n_valid, int k, int ranges,
                 int stages, int dp, int p, int* __restrict__ flushes) {
  constexpr int kCols = kSwzRowBytes / sizeof(T);  // columns of a stage
  constexpr bool kMma = scan_mma(sizeof(T) == 2, QT);
  constexpr bool kBlocked = sizeof(T) == 4 && scan_buffered(QT);
  extern __shared__ unsigned char scan_smem_raw[];
  const uint32_t raw = smem_addr(scan_smem_raw);
  const uint32_t ring =
      (raw + kSwzAtomBytes - 1) & ~(uint32_t)(kSwzAtomBytes - 1);
  const unsigned char* ring_p = scan_smem_raw + (ring - raw);
  const int S = stages, dq = dp + 8;
  const uint32_t full = ring + S * kScanStageBytes, empty = full + 8 * S;
  unsigned char* qarea = scan_smem_raw + (ring - raw) +
                         (size_t)S * (kScanStageBytes + 16);
  float* sq = reinterpret_cast<float*>(qarea);
  bf16* sqb = reinterpret_cast<bf16*>(qarea);
  float* sbuf = reinterpret_cast<float*>(qarea + scan_q_bytes(kMma, QT, dp));
  uint64_t* lists = reinterpret_cast<uint64_t*>(
      qarea + scan_q_bytes(kMma, QT, dp) + scan_sb_bytes(QT));
  uint64_t* taus = lists + QT * p;
  int* cnts = reinterpret_cast<int*>(taus + QT);
  int* locks = cnts + QT;
  int* last = locks + QT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.y * QT, kb_n = dp / kCols;
  const int blocks = (n_rows + kScanRows - 1) / kScanRows;
  const int b0 = (int)((long long)blockIdx.x * blocks / ranges);
  const int b1 = (int)((long long)(blockIdx.x + 1) * blocks / ranges);

  for (int i = tid; i < QT * dp; i += kScanThreads) {
    int q, c;
    if constexpr (kMma) {
      q = i / dp;
      c = i % dp;
    } else {
      q = (i / kCols) % QT;
      c = i / (QT * kCols) * kCols + i % kCols;
    }
    float v = q0 + q < Q && c < D ? queries[(size_t)(q0 + q) * D + c] : 0.f;
    if (sizeof(T) == 2) v = __bfloat162float(__float2bfloat16_rn(v));
    if constexpr (kMma)
      sqb[q * dq + c] = __float2bfloat16_rn(v);
    else
      sq[i] = v;
  }
  for (int i = tid; i < QT * p; i += kScanThreads) lists[i] = 0ull;
  for (int i = tid; i < QT; i += kScanThreads) {
    taus[i] = 0ull;
    cnts[i] = 0;
    locks[i] = 0;
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kScanWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kScanWarps) {  // producer
    if (lane == 0) {
      const int total = (b1 - b0) * kb_n;
      for (int it = 0; it < total; ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);
        mbar_expect_tx(full + 8 * s, kScanStageBytes);
        tma_load_2d(ring + s * kScanStageBytes, &tma_db, (it % kb_n) * kCols,
                    (b0 + it / kb_n) * kScanRows, full + 8 * s);
      }
    }
    return;
  }

  const int rr = warp * 32 + lane;  // this lane's row of every stage
  const int qn = min(QT, Q - q0), cap = p - k;
  int it = 0;
  for (int b = b0; b < b1; ++b) {
    float sc[QT];  // a lane a row: its scores once the block is read
    float* wb = sbuf + warp * 32 * (QT + 1);  // the warp's score buffer
    if constexpr (kMma) {
      float acc[2][QT / 8][4] = {};
      for (int kb = 0; kb < kb_n; ++kb, ++it) {
        const int s = it % S;
        mbar_wait(full + 8 * s, (it / S) & 1);
        score_stage_mma<QT>(ring + s * kScanStageBytes, warp, lane,
                            smem_addr(sqb + kb * kCols), dq, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < QT / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            wb[(16 * m + g + 8 * (e >> 1)) * (QT + 1) + 8 * n + 2 * t +
               (e & 1)] = acc[m][n][e];
    } else if constexpr (kBlocked) {
      float acc[4][QT / 4] = {};
      for (int kb = 0; kb < kb_n; ++kb, ++it) {
        const int s = it % S;
        mbar_wait(full + 8 * s, (it / S) & 1);
        float part[4][QT / 4] = {};
        score_stage_blocked<QT>(ring_p + s * kScanStageBytes, warp, lane,
                                sq + kb * QT * kCols, part);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int g = 0; g < QT / 4; ++g) acc[i][g] += part[i][g];
      }
      const int u = lane >> 3, v = lane & 7;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < QT / 4; ++g)
          wb[(v + 8 * i) * (QT + 1) + QT / 4 * u + g] = acc[i][g];
    } else {
#pragma unroll
      for (int q = 0; q < QT; ++q) sc[q] = 0.f;
      for (int kb = 0; kb < kb_n; ++kb, ++it) {
        const int s = it % S;
        mbar_wait(full + 8 * s, (it / S) & 1);
        float part[QT];
#pragma unroll
        for (int q = 0; q < QT; ++q) part[q] = 0.f;
        score_stage<T, QT>(ring_p + s * kScanStageBytes + rr * kSwzRowBytes,
                           rr & 7, sq + kb * QT * kCols, part);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
        for (int q = 0; q < QT; ++q) sc[q] += part[q];
      }
    }
    // the filter: rows >= n_valid (zero padding, which would outscore
    // negative true scores, and TMA's zeros past n_rows) never survive
    const int row = b * kScanRows + rr;
    const bool valid = row < n_valid;
    if constexpr (scan_buffered(QT)) {
      // the sums to a row a lane through the buffer, read from it in an
      // order that starts at query ``warp``, so that the warps, which reach
      // a block's votes together, take different queries' locks
      __syncwarp();
      for (int i = 0; i < qn; ++i) {
        const int q = (i + warp) % qn;
        const float v = wb[lane * (QT + 1) + q];
        scan_vote(valid ? pack(score_key(v), row) : 0ull, q, lists, taus,
                  cnts, locks, k, cap, p, lane, flushes);
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int q = 0; q < QT; ++q)
        if (q < qn)
          scan_vote(valid ? pack(score_key(sc[q]), row) : 0ull, q, lists,
                    taus, cnts, locks, k, cap, p, lane, flushes);
    }
  }

  // every consumer's appends are in: each query's list to its first k
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kScanWarps) : "memory");
  for (int q = warp; q < qn; q += kScanWarps) {
    uint64_t* lst = lists + q * p;
    scan_sort(lst, k + cnts[q], p, lane);
    const size_t o = ((size_t)blockIdx.x * Q + q0 + q) * k;
    for (int j = lane; j < k; j += 32) {
      const uint64_t e = lst[j];
      out_s[o + j] = e ? key_score((uint32_t)(e >> 32)) : -INFINITY;
      out_r[o + j] = e ? (int)~(uint32_t)e : 0;
    }
  }
  if (!top_s) return;

  // the last CTA of the query tile merges: every range's candidates are
  // written and fenced before its ticket
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kScanWarps) : "memory");
  if (tid == 0) *last = atomicAdd(tickets + blockIdx.y, 1) == ranges - 1;
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kScanWarps) : "memory");
  if (!*last) return;
  __threadfence();
  for (int i = tid; i < qn * p; i += 32 * kScanWarps) lists[i] = 0ull;
  // each range's k-th word is a lower bound of the query's k-th best (k
  // words of that range are >= it), so the merge's τ starts just under the
  // largest of them: only words >= it can be in the answer
  for (int q = warp; q < qn; q += kScanWarps) {
    uint64_t b = 0ull;
    for (int r = lane; r < ranges; r += 32) {
      const size_t o = ((size_t)r * Q + q0 + q) * k + k - 1;
      const float sv = __ldcg(out_s + o);
      const uint64_t w =
          sv != -INFINITY ? pack(score_key(sv), __ldcg(out_r + o)) : 0ull;
      b = w > b ? w : b;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const uint64_t w = shfl64(b, lane ^ off);
      b = w > b ? w : b;
    }
    if (lane == 0) {
      taus[q] = b ? b - 1 : 0ull;
      cnts[q] = 0;
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kScanWarps) : "memory");
  // a lane a range: each (query, 32 ranges) item walks the ranges' sorted
  // candidates kMergeDepth at a time (their loads in flight together), a
  // lane's range left at its first entry under τ, the item at the depth no
  // lane passes; the items spread over the warps query first, so that
  // warps at work together take different queries' locks
  constexpr int kMergeDepth = 4;
  const int groups = (ranges + 31) / 32;
  for (int item = warp; item < qn * groups; item += kScanWarps) {
    const int q = item % qn, r = item / qn * 32 + lane;
    const size_t o = ((size_t)r * Q + q0 + q) * k;
    bool alive = r < ranges;
    for (int j0 = 0; j0 < k && __any_sync(0xffffffffu, alive);
         j0 += kMergeDepth) {
      uint64_t keys[kMergeDepth];
#pragma unroll
      for (int d = 0; d < kMergeDepth; ++d) {
        keys[d] = 0ull;
        if (alive && j0 + d < k) {
          const float sv = __ldcg(out_s + o + j0 + d);
          if (sv != -INFINITY)
            keys[d] = pack(score_key(sv), __ldcg(out_r + o + j0 + d));
        }
      }
#pragma unroll
      for (int d = 0; d < kMergeDepth; ++d) {
        const uint64_t t = *static_cast<volatile uint64_t*>(taus + q);
        alive = alive && keys[d] > t;
        if (__any_sync(0xffffffffu, alive))
          scan_append(alive ? keys[d] : 0ull, lists + q * p, taus + q,
                      cnts + q, locks + q, k, cap, p, lane, nullptr);
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kScanWarps) : "memory");
  for (int q = warp; q < qn; q += kScanWarps) {
    uint64_t* lst = lists + q * p;
    scan_sort(lst, k + cnts[q], p, lane);
    const size_t o = (size_t)(q0 + q) * k;
    for (int j = lane; j < k; j += 32) {
      const uint64_t e = lst[j];
      top_s[o + j] = e ? key_score((uint32_t)(e >> 32)) : -INFINITY;
      top_r[o + j] = e ? (long long)(int)~(uint32_t)e : 0;
    }
  }
}

template <typename T, int QT>
cudaError_t launch_scan(const CUtensorMap& map, const float* queries,
                        float* out_s, int* out_r, float* top_s,
                        long long* top_r, int* tickets, int Q, int D,
                        int n_rows, int n_valid, int k, int ranges,
                        int stages, int dp, int p, int* flushes,
                        cudaStream_t st) {
  const size_t smem =
      scan_smem(scan_mma(sizeof(T) == 2, QT), QT, stages, dp, p);
  auto kernel = topk_scan_kernel<T, QT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ranges, (Q + QT - 1) / QT);
  kernel<<<grid, kScanThreads, smem, st>>>(
      map, queries, out_s, out_r, top_s, top_r, tickets, Q, D, n_rows,
      n_valid, k, ranges, stages, dp, p, flushes);
  return cudaGetLastError();
}

template <typename T, typename... Args>
cudaError_t launch_scan_qt(int qt, Args... args) {
  switch (qt) {
    case 1:
      return launch_scan<T, 1>(args...);
    case 8:
      return launch_scan<T, 8>(args...);
    default:
      return launch_scan<T, kScanMaxQT>(args...);
  }
}

}  // namespace

extern "C" {

// The served query's scan: queries (Q, D) f32, db (n_rows, D) f32 (bf16_db
// 0) or bf16 (1), 16-byte aligned, against ``ranges`` CTAs' ranges of whole
// 256-row blocks (range i: blocks [i B / ranges, (i + 1) B / ranges), B =
// ceil(n_rows / 256)) -> out_s / out_r (ranges, Q, k): each range's first k
// of each query by (score descending, row ascending), sorted, rows >=
// n_valid left out, a range with fewer than k valid rows filled with (-inf,
// 0). With top_s (null: no merge), the first k of them all into top_s (Q, k)
// f32 and top_r (Q, k) int64, merged in the kernel; ``tickets`` then holds
// one int for each query tile, zeroed here on ``stream`` before the launch.
// ``qt`` (1, 8 or 16) queries a CTA share one read of the rows, each with a
// list of ``p`` entries (a power of two >= 128 and >= k + max(k, 32));
// ops/fused_topk.py scan_plan chooses ranges, qt and p. ``flushes`` (one
// device int, or null) counts the lists that passed their capacity and were
// flushed.
int wt_topk_threshold(const float* queries, const void* db, int bf16_db,
                      float* out_s, int* out_r, float* top_s,
                      long long* top_r, int* tickets, int Q, int D,
                      int n_rows, int n_valid, int k, int ranges, int qt,
                      int p, int* flushes, void* stream) {
  if (Q < 1 || D < 8 || D % 8 || D > kScanMaxD || n_rows < 1 ||
      n_valid < 0 || n_valid > n_rows || k < 1 || k > 1024 || ranges < 1 ||
      ranges > (n_rows + kScanRows - 1) / kScanRows ||
      (qt != 1 && qt != 8 && qt != kScanMaxQT) || (Q + qt - 1) / qt > 65535 ||
      p < 128 || (p & (p - 1)) || p < k + (k > 32 ? k : 32) ||
      (top_s && (!top_r || !tickets)))
    return (int)cudaErrorInvalidValue;
  const int cols = bf16_db ? 64 : 32;  // columns of a stage's 128-byte rows
  const int dp = (D + cols - 1) / cols * cols;
  const long long room =
      kScanSmemMax -
      (long long)scan_smem(scan_mma(bf16_db, qt), qt, 0, dp, p);
  const long long fit = room / (kScanStageBytes + 16);
  const int stages = (int)(fit < kScanMaxStages ? fit : kScanMaxStages);
  if (stages < kScanMinStages) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (top_s)
    WT_CHECK(cudaMemsetAsync(tickets, 0, sizeof(int) * ((Q + qt - 1) / qt),
                             st));
  CUtensorMap map;
  if (bf16_db) {
    WT_CHECK(tile_map<bf16>(&map, static_cast<const bf16*>(db), n_rows, D, D,
                            kScanRows, cols));
    return (int)launch_scan_qt<bf16>(qt, map, queries, out_s, out_r, top_s,
                                     top_r, tickets, Q, D, n_rows, n_valid, k,
                                     ranges, stages, dp, p, flushes, st);
  }
  WT_CHECK(tile_map<float>(&map, static_cast<const float*>(db), n_rows, D, D,
                           kScanRows, cols));
  return (int)launch_scan_qt<float>(qt, map, queries, out_s, out_r, top_s,
                                    top_r, tickets, Q, D, n_rows, n_valid, k,
                                    ranges, stages, dp, p, flushes, st);
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
  static PerDevice smem_set;
  WT_CHECK(max_dynamic_smem(smem_set, topk_gemm_f32_kernel, (int)kF32Smem));
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
