"""The layouts behind the port's GEMM (wise_tpu_torch/csrc/common.cuh,
``gemm_kernel``), rehearsed on the CPU.

The kernel cannot run here. This file reads its layout constants from
common.cuh itself (``kGemmBK``, ``kWgRows``, ``kWgmmaK``, ``kBoxCols``,
``kSwzRowBytes``, ``kSwzAtomBytes``, ``kDesc*``) and models, byte for byte:

- TMA's 128-byte swizzle as it writes a box into shared memory: the 16-byte
  chunk c of box row r lands at chunk c ^ (r % 8) of that row;
- the wgmma shared-memory descriptor as the kernel encodes it (start address,
  leading and stride byte offsets in 16-byte units, the layout type in bits
  62-63), and the addresses the tensor cores read under it: the canonical
  layouts of a K-major A and an MN-major B (transpose-B) operand, with the
  128-byte swizzle applied to the address (bits 4-6 ^= bits 7-9);
- the m64nNk16 accumulator (D fragment) map the epilogue stores from.

The two swizzle models are independent (one by box row, one by address
bits): they agree only where the kernel keeps its stages on a 1024-byte
atom, which is what the product checks. The emulated kernel, stage by stage,
reads its fragments through the descriptors and must give A @ W exactly
(integer-valued inputs) on tiles with ragged M, N and K edges, for each of
the three tile shapes the host picks from; the epilogue map must cover a
64 x N tile exactly once. Planted faults (LBO and SBO swapped, a stage off
the atom, the K-step of a row of W taken as a column step) must give a wrong
product.

The same for the f32 group path's product (csrc/topk_kernels.cu
``topk_gemm_f32_kernel``, constants ``kF32*``): the ring on f32 elements (32
a swizzled row), each thread's two 16-byte reads of its A rows (chunk (2t +
c) ^ g), the TF32 split in registers and the m64nNk8 tf32 A fragment, the
K-major B descriptor on the wrapper's q_hi / q_lo (ops.fused_topk.tf32_split,
columns permuted to the fragment order), three products a k8 step, and the
masked stores: it must equal hi(db) q_hi + hi(db) q_lo + lo(db) q_hi exactly
(values on a 2^-8 grid: every sum exact) at ragged M, N and K; the column
permutation left out, the reads unswizzled, or the fragment's columns
swapped must not.
"""

import re
from pathlib import Path

import numpy as np
import pytest

CUH = Path(__file__).resolve().parents[1] / "wise_tpu_torch" / "csrc" / \
    "common.cuh"


def _constants():
    """The kernel's ``constexpr`` layout constants, evaluated in order."""
    text = CUH.read_text()
    names = {}
    for name, expr in re.findall(
            r"constexpr (?:int|uint64_t) "
            r"(k(?:Gemm|Wg|Wgmma|Box|Swz|Desc|Smem)\w*) = ([^;]+);", text):
        names[name] = eval(expr.replace("ull", ""), {}, dict(names))
    return names


C = _constants()
BK, WG_ROWS, WK = C["kGemmBK"], C["kWgRows"], C["kWgmmaK"]
BOX_COLS, ROW_BYTES, ATOM = C["kBoxCols"], C["kSwzRowBytes"], \
    C["kSwzAtomBytes"]
#: (consumer warpgroups, BN) of the three tiles gemm() picks from
TILES = [(2, 256), (2, 128), (1, 64)]


def stages(wg, bn):
    """common.cuh GemmTile: (stages, stage bytes, block's budget): as many
    stages (and their two barriers) as fit the block's share of an SM's
    shared memory beside the atom of alignment room, up to the cap."""
    stage = wg * WG_ROWS * BK * 2 + BK * bn * 2
    blocks = 1 if bn > 128 else C["kGemmBlocksPerSM"]
    budget = C["kSmemPerSM"] // blocks - 1024
    fit = (budget - ATOM) // (stage + 16)
    return min(fit, C["kGemmMaxStages"]), stage, budget


def test_constants_are_the_swizzle_s():
    """The constants hang together: a stage's K is one swizzled row of bf16,
    a W box is one such row wide, the atom is 8 rows, the descriptors'
    strides are the atom and the box, the layout type is 128-byte swizzle
    (1 in bits 62-63), and every tile's ring (4 stages at 128 x 256, one
    block an SM; 3 at 128 x 128, two) fits its share of the SM's 228 KB, on
    stages that stay on the atom."""
    assert BK * 2 == ROW_BYTES == BOX_COLS * 2 == 128
    assert ATOM == 8 * ROW_BYTES
    assert C["kDescSboA"] == C["kDescSboW"] == ATOM
    assert C["kDescLboW"] == BK * ROW_BYTES  # one W box: BK rows of K
    assert C["kDescSwizzle128"] >> 62 == 1
    assert C["kGemmBM"] == 2 * WG_ROWS and BK % WK == 0
    assert C["kSmemPerSM"] == 228 * 1024
    assert [stages(wg, bn)[0] for wg, bn in TILES] == [4, 3, 6]
    for wg, bn in TILES:
        n, stage, budget = stages(wg, bn)
        assert stage % ATOM == 0 and n >= 3
        assert n * (stage + 16) + ATOM <= min(budget, 227 * 1024)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def desc(addr, lbo, sbo):
    """common.cuh smem_desc: the 64-bit wgmma descriptor."""
    return (((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16)
            | (((sbo >> 4) & 0x3FFF) << 32) | C["kDescSwizzle128"])


def fields(d):
    """(start, lbo, sbo) in bytes and the layout type of a descriptor."""
    return ((d & 0x3FFF) << 4, ((d >> 16) & 0x3FFF) << 4,
            ((d >> 32) & 0x3FFF) << 4, d >> 62)


def swizzle(addr):
    """The 128-byte swizzle on a shared-memory byte address."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box(smem, dst, g, c0, c1, rows):
    """Write the box of ``rows`` x BOX_COLS elements of the logical matrix g
    at (inner c0, outer c1) into smem (one f64 slot per bf16, indexed by
    byte address / 2) at byte dst, as TMA does under SWIZZLE_128B: zeros past
    g's edges, chunk c of box row r at chunk c ^ (r % 8)."""
    r = np.arange(rows)[:, None]
    c = np.arange(BOX_COLS)[None, :]
    gr, gc = c1 + r, c0 + c
    inside = (gr < g.shape[0]) & (gc < g.shape[1])
    vals = np.where(inside, g[np.minimum(gr, g.shape[0] - 1),
                              np.minimum(gc, g.shape[1] - 1)], 0.0)
    chunk = (c * 2) // 16
    byte = dst + r * ROW_BYTES + ((chunk ^ (r % 8)) * 16) + (c * 2) % 16
    smem[byte // 2] = vals


def read_a(smem, d):
    """The 64 x 16 A fragment (K-major) a descriptor reads."""
    start, _, sbo, layout = fields(d)
    assert layout == 1
    i = np.arange(WG_ROWS)[:, None]
    k = np.arange(WK)[None, :]
    addr = (start + (i % 8) * ROW_BYTES + (i // 8) * sbo + (k // 8) * 16
            + (k % 8) * 2)
    return smem[swizzle(addr) // 2]


def read_w(smem, d, bn):
    """The 16 x bn W fragment (MN-major, transpose-B) a descriptor reads."""
    start, lbo, sbo, layout = fields(d)
    assert layout == 1
    k = np.arange(WK)[:, None]
    n = np.arange(bn)[None, :]
    addr = (start + (n % 64) * 2 + (n // 64) * lbo + (k % 8) * ROW_BYTES
            + (k // 8) * sbo)
    return smem[swizzle(addr) // 2]


def d_fragment(bn):
    """(thread, register) -> (row, column) of the m64nNk16 accumulator:
    register 4j + 2h + e of thread t holds row 16 (t / 32) + (t % 32) / 4 +
    8h, column 8j + 2 (t % 4) + e."""
    t = np.arange(128)[:, None]
    i = np.arange(bn // 2)[None, :]
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2)
    col = 8 * (i // 4) + 2 * (t % 4) + (i % 2)
    return row, col


def emulate(a, w, wg, bn, lbo_w=None, sbo_w=None, skew=0, w_step=None):
    """The kernel's mainloop and epilogue on a (M, K) @ (K, N), tile by tile:
    the producer's TMA boxes into a stage, the consumers' descriptors and
    k16 steps, the D fragment, the masked column-pair stores. Returns the
    output and a count of the stores to each element. The keyword arguments
    plant faults."""
    m, k = a.shape
    n = w.shape[1]
    bm = wg * WG_ROWS
    lbo_w = C["kDescLboW"] if lbo_w is None else lbo_w
    sbo_w = C["kDescSboW"] if sbo_w is None else sbo_w
    w_step = WK * ROW_BYTES if w_step is None else w_step
    a_bytes = bm * BK * 2
    out = np.zeros((m, n))
    stores = np.zeros((m, n), int)
    row, col = d_fragment(bn)
    for m0 in range(0, m, bm):
        for n0 in range(0, n, bn):
            acc = np.zeros((wg, WG_ROWS, bn))
            for kt in range(-(-k // BK)):
                smem = np.full((a_bytes + BK * bn * 2 + ATOM) // 2, np.nan)
                ring = skew  # the stage's byte address
                tma_box(smem, ring, a, kt * BK, m0, bm)
                for j in range(bn // BOX_COLS):
                    tma_box(smem, ring + a_bytes + j * BK * ROW_BYTES, w,
                            n0 + j * BOX_COLS, kt * BK, BK)
                for g in range(wg):
                    a_s = ring + g * WG_ROWS * ROW_BYTES
                    w_s = ring + a_bytes
                    for kk in range(BK // WK):
                        fa = read_a(smem, desc(a_s + kk * WK * 2,
                                               C["kDescLboA"],
                                               C["kDescSboA"]))
                        fw = read_w(smem, desc(w_s + kk * w_step, lbo_w,
                                               sbo_w), bn)
                        acc[g] += fa @ fw
            for g in range(wg):
                regs = acc[g][row, col]  # (thread, register)
                warp, lane = np.arange(128) // 32, np.arange(128) % 32
                r0 = m0 + g * WG_ROWS + (warp % 4) * 16 + lane // 4
                c0 = n0 + (lane % 4) * 2
                for j in range(bn // 8):
                    for h in range(2):
                        for e in range(2):
                            gr, gc = r0 + 8 * h, c0 + 8 * j + e
                            ok = (gr < m) & (c0 + 8 * j < n)
                            out[gr[ok], gc[ok]] = regs[ok, 4 * j + 2 * h + e]
                            np.add.at(stores, (gr[ok], gc[ok]), 1)
    return out, stores


def _operands(m, n, k, seed):
    """Integer-valued A and W: every sum is exact, so the emulation must
    equal A @ W to the last bit whatever the order of the sum."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, (m, k)).astype(np.float64),
            rng.integers(-4, 5, (k, n)).astype(np.float64))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bn", [64, 128])
def test_d_fragment_covers_the_tile_once(bn):
    row, col = d_fragment(bn)
    cover = np.zeros((WG_ROWS, bn), int)
    np.add.at(cover, (row, col), 1)
    assert (cover == 1).all()
    # the epilogue's column pairs: registers 2i and 2i + 1 are neighbours
    assert (col[:, 1::2] == col[:, ::2] + 1).all()
    assert (row[:, 1::2] == row[:, ::2]).all()


def test_descriptor_fields_round_trip():
    for addr in (0, 1024, 8192 + 32, 131072 + 2048, 232448 - 1024):
        for lbo, sbo in ((16, ATOM), (C["kDescLboW"], ATOM)):
            assert fields(desc(addr, lbo, sbo)) == (addr, lbo, sbo, 1)


@pytest.mark.parametrize("bn", [64, 128])
def test_tma_box_and_descriptors_agree_on_one_stage(bn):
    """The A and W fragments a consumer reads through its descriptors at each
    k16 step are the operand's own elements."""
    a, w = _operands(64, bn, BK, 3)
    a_bytes = WG_ROWS * BK * 2
    smem = np.full((a_bytes + BK * bn * 2) // 2, np.nan)
    tma_box(smem, 0, a, 0, 0, WG_ROWS)
    for j in range(bn // BOX_COLS):
        tma_box(smem, a_bytes + j * BK * ROW_BYTES, w, j * BOX_COLS, 0, BK)
    for kk in range(BK // WK):
        ks = slice(kk * WK, (kk + 1) * WK)
        fa = read_a(smem, desc(kk * WK * 2, C["kDescLboA"], C["kDescSboA"]))
        fw = read_w(smem, desc(a_bytes + kk * WK * ROW_BYTES,
                               C["kDescLboW"], C["kDescSboW"]), bn)
        np.testing.assert_array_equal(fa, a[:, ks])
        np.testing.assert_array_equal(fw, w[ks])


#: (M, N, K): ragged M (a 128-row tile's last 64 rows, and 37 rows), ragged N
#: (Swin's 96 and 288 against 128-wide tiles), ragged K (96 = 64 + 32 as at
#: Swin stage 0, 160 as the fold's 608 ends: 32 past a whole stage)
SHAPES = [(192, 256, 128), (37, 96, 96), (130, 288, 160), (64, 64, 64)]


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("wg,bn", TILES)
def test_emulated_kernel_equals_a_at_w(wg, bn, m, n, k):
    a, w = _operands(m, n, k, m * n + k)
    out, stores = emulate(a, w, wg, bn)
    np.testing.assert_array_equal(out, a @ w)
    assert (stores == 1).all()


@pytest.mark.parametrize("fault", ["lbo_sbo_swapped", "stage_off_atom",
                                   "w_k_step_as_column"])
def test_planted_layout_faults_break_the_product(fault):
    a, w = _operands(130, 288, 160, 7)
    kw = {"lbo_sbo_swapped": dict(lbo_w=C["kDescSboW"],
                                  sbo_w=C["kDescLboW"]),
          "stage_off_atom": dict(skew=512),
          "w_k_step_as_column": dict(w_step=WK * 2)}[fault]
    out, _ = emulate(a, w, 2, 128, **kw)
    assert not np.array_equal(out, a @ w)


# ---------------------------------------------------------------------------
# the f32 group path's product (csrc/topk_kernels.cu topk_gemm_f32_kernel):
# the same ring and swizzle on f32 elements, A split in registers, three tf32
# wgmma (m64n64k8, register A, K-major B) a k8 step
# ---------------------------------------------------------------------------

import torch  # noqa: E402

from wise_tpu_torch.ops import fused_topk as FT  # noqa: E402

TOPK_CU = CUH.parent / "topk_kernels.cu"


def _f32_constants():
    names = dict(C)
    for name, expr in re.findall(r"constexpr (?:int|size_t) (kF32\w*) =\s*"
                                 r"([^;]+);", TOPK_CU.read_text()):
        expr = re.sub(r"\(size_t\)", "", expr).replace("/", "//")
        names[name] = eval(expr, {}, names)
    return names


F32 = _f32_constants()
F32_BK, F32_BN, F32_TILES, F32_WG, F32_K = (
    F32["kF32BK"], F32["kF32BN"], F32["kF32Tiles"], F32["kF32Wg"],
    F32["kF32WgmmaK"])
F32_BM = F32["kF32BM"]


def test_f32_constants_hang_together():
    """A stage's K is one swizzled row of f32 (32 values), a k8 step is 32
    bytes as the bf16 path's k16, the tile is the consumer warpgroups' m64
    tiles by a 64-query chunk, and the ring (as many stages as fit) holds
    three at least on the atom and fits one block an SM."""
    assert F32_BK * 4 == ROW_BYTES and F32_K * 4 == WK * 2
    assert F32_BM == F32_WG * F32_TILES * WG_ROWS and F32_BN == 64
    stage = F32["kF32StageBytes"]
    assert stage == F32_BM * ROW_BYTES + 2 * F32_BN * ROW_BYTES
    assert stage % ATOM == 0
    assert F32["kF32Stages"] == (C["kSmemPerSM"] - 1024 - ATOM) // (stage + 16)
    assert F32["kF32Stages"] >= 3
    assert F32["kF32Smem"] <= 227 * 1024


def tma_box_f32(smem, dst, g, c0, c1, rows):
    """tma_box on 4-byte elements (32 a 128-byte box row), smem indexed by
    byte address / 4."""
    cols = ROW_BYTES // 4
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    gr, gc = c1 + r, c0 + c
    inside = (gr < g.shape[0]) & (gc < g.shape[1])
    vals = np.where(inside, g[np.minimum(gr, g.shape[0] - 1),
                              np.minimum(gc, g.shape[1] - 1)], 0.0)
    chunk = (c * 4) // 16
    byte = dst + r * ROW_BYTES + ((chunk ^ (r % 8)) * 16) + (c * 4) % 16
    smem[byte // 4] = vals


def read_b_tf32(smem, d):
    """The 8 x 64 B fragment (K-major, tf32) a descriptor reads: column n
    of B is row n of the box, k its 4-byte element."""
    start, _, sbo, layout = fields(d)
    assert layout == 1
    k = np.arange(F32_K)[:, None]
    n = np.arange(F32_BN)[None, :]
    addr = (start + (n % 8) * ROW_BYTES + (n // 8) * sbo + (k // 4) * 16
            + (k % 4) * 4)
    return smem[swizzle(addr) // 4]


def a_fragment_tf32():
    """(thread, register) -> (row, column) of the m64 x k8 tf32 A fragment:
    warp w rows 16w ..; a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
    t + 4), g = lane / 4, t = lane % 4."""
    t = np.arange(128)[:, None]
    i = np.arange(4)[None, :]
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * (i % 2)
    col = (t % 4) + 4 * (i // 2)
    return row, col


def tf32_rna(x):
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32).astype(np.float64)


def emulate_f32(db, q, perm=True, swizzle_reads=True, swap_a=False):
    """The f32 kernel on db (M, K) f32 and q (N, K) f32 -> Sᵀ (M, N): the
    wrapper's operand (ops.fused_topk.tf32_split), the producer's boxes, the
    consumers' 16-byte reads of A (chunk (2t + c) ^ g), the split, the k8
    steps' fragments and descriptors, the D fragment and the masked stores.
    Keyword arguments plant faults."""
    m, k = db.shape
    n = q.shape[0]
    qs = FT.tf32_split(torch.from_numpy(q))
    if not perm:  # the wrapper's column order left out
        d_pad = qs.shape[2]
        inv = torch.argsort(FT.tf32_permutation(d_pad))
        qs = qs[:, :, inv]
    qs = qs.reshape(2 * n, -1).numpy().astype(np.float64)
    out = np.full((m, n), np.nan)
    row_d, col_d = d_fragment(F32_BN)
    a_row, a_col = a_fragment_tf32()
    tid = np.arange(128)
    warp, lane = tid // 32, tid % 32
    g, t4 = lane // 4, lane % 4
    a_bytes = F32_BM * ROW_BYTES
    for m0 in range(0, m, F32_BM):
        acc = np.zeros((F32_WG, F32_TILES, 128, F32_BN // 2))
        for kt in range(-(-k // F32_BK)):
            smem = np.full((F32["kF32StageBytes"]) // 4, np.nan)
            tma_box_f32(smem, 0, db.astype(np.float64), kt * F32_BK, m0,
                        F32_BM)
            tma_box_f32(smem, a_bytes, qs, kt * F32_BK, 0, F32_BN)
            tma_box_f32(smem, a_bytes + F32_BN * ROW_BYTES, qs, kt * F32_BK,
                        n, F32_BN)
            for wg in range(F32_WG):
                for t in range(F32_TILES):
                    # v[h]: (thread, 8) physical columns 8 t4 .. of row g + 8h
                    v = []
                    for h in range(2):
                        row = (wg * F32_TILES + t) * 64 + warp * 16 + g + 8 * h
                        cols = []
                        for c in range(2):
                            ch = (2 * t4 + c) ^ g if swizzle_reads else \
                                2 * t4 + c
                            base = row * ROW_BYTES + ch * 16
                            cols += [smem[(base + 4 * e) // 4]
                                     for e in range(4)]
                        v.append(np.stack(cols, axis=1))
                    for kk in range(F32_BK // F32_K):
                        x = np.stack([v[0][:, 2 * kk], v[1][:, 2 * kk],
                                      v[0][:, 2 * kk + 1],
                                      v[1][:, 2 * kk + 1]], axis=1)
                        if swap_a:
                            x = x[:, [0, 2, 1, 3]]
                        hi = tf32_rna(x)
                        lo = tf32_rna((x - hi).astype(np.float32))
                        # registers -> the logical 64 x 8 A of this step
                        a_hi = np.zeros((64, F32_K))
                        a_lo = np.zeros((64, F32_K))
                        a_hi[a_row, a_col] = hi
                        a_lo[a_row, a_col] = lo
                        qh = a_bytes + kk * F32_K * 4
                        b_hi = read_b_tf32(smem, desc(qh, C["kDescLboA"],
                                                      C["kDescSboA"]))
                        b_lo = read_b_tf32(smem, desc(
                            qh + F32_BN * ROW_BYTES, C["kDescLboA"],
                            C["kDescSboA"]))
                        d = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
                        acc[wg, t] += d[row_d, col_d]
        for wg in range(F32_WG):
            for t in range(F32_TILES):
                regs = acc[wg, t]
                r = m0 + (wg * F32_TILES + t) * 64 + row_d
                c = col_d
                ok = (r < m) & (c < n)
                out[r[ok], c[ok]] = regs[ok]
    return out


def three_terms(db, q):
    """hi(db) q_hi + hi(db) q_lo + lo(db) q_hi in float64."""
    dh = tf32_rna(db)
    dl = tf32_rna((db - dh).astype(np.float32))
    qh = tf32_rna(q)
    ql = tf32_rna((q - qh).astype(np.float32))
    return dh @ qh.T + dh @ ql.T + dl @ qh.T


def _f32_operands(m, n, k, seed):
    """Values on a grid of 2^-8 below 2^12: hi and lo both non-zero, every
    product a multiple of 2^-16 and every sum exact in float64, so the
    emulation must equal three_terms to the last bit whatever the order."""
    rng = np.random.default_rng(seed)
    db = (rng.integers(-2 ** 20, 2 ** 20, (m, k)) / 256).astype(np.float32)
    q = (rng.integers(-2 ** 20, 2 ** 20, (n, k)) / 256).astype(np.float32)
    return db, q


#: (M, N, K): ragged M (a 256-row tile's tail, two tiles), N = the query
#: chunk's Q_pad (8 to 64), ragged K (72: a block of 32 with 24 zero
#: columns; 8)
F32_SHAPES = [(300, 16, 72), (64, 8, 8), (257, 64, 96), (40, 40, 32)]


@pytest.mark.parametrize("m,n,k", F32_SHAPES)
def test_emulated_f32_kernel_equals_the_three_term_product(m, n, k):
    db, q = _f32_operands(m, n, k, m + n + k)
    assert tf32_rna(db).tolist() != db.astype(np.float64).tolist()
    np.testing.assert_array_equal(emulate_f32(db, q), three_terms(db, q))


@pytest.mark.parametrize("fault", ["columns_unpermuted", "reads_unswizzled",
                                   "fragment_columns_swapped"])
def test_planted_f32_layout_faults_break_the_product(fault):
    db, q = _f32_operands(300, 16, 72, 9)
    kw = {"columns_unpermuted": dict(perm=False),
          "reads_unswizzled": dict(swizzle_reads=False),
          "fragment_columns_swapped": dict(swap_a=True)}[fault]
    assert not np.array_equal(emulate_f32(db, q, **kw), three_terms(db, q))
