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
