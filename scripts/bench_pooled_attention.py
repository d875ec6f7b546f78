#!/usr/bin/env python3
"""Time the pooled attention kernel (wise_tpu_torch/csrc/block_kernels.cu
``attention_pooled_kernel``, behind ``fused_attn_block_pooled`` and
``fused_attn_block_pooled_dyn``) alone on one CUDA card, in builds of the
source with its tiling constants changed, at every head group.

    python3 scripts/bench_pooled_attention.py

Each build (VARIANTS: threads a block, segments a group takes a tile, ring
stages; ``reverse``: the source with the examples taken in reverse, so
that the rows the kv GEMM wrote last, still in L2, would be read first)
compiles block_kernels.cu with nvcc into build/bench/, all builds
at once, and binds ``wt_attention_pooled`` and ``wt_attn_block_pooled``.
At the pooled shapes of
chip_smoke.py's BLOCK_SHAPES (seeded q and kv ~ N(0, 1) in bf16; the causal
towers at DYN_ROWS), every build runs at the kernel's own head group (0)
and at each group that divides the heads; each output is held to
ops.block.plain_pooled_attention on the whole output (output_agreement)
before it is timed. Times: the kernel's device ms (torch.profiler self
time, 20 calls after 3), with F.scaled_dot_product_attention on the same
q, k, v timed the same way, and the bytes bound (k and v of the kept keys,
q, the output, at 3.35 TB/s); ``in_block_ms``: the kernel's own device ms
inside the whole pooled block's call (seeded x and weights, the kv GEMM
writing kv just before it, as on the paths). One ``[pooled-bench]`` line a
shape and build. Needs nvcc and one card.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import BLOCK_SHAPES, DYN_ROWS, PEAK_BYTES  # noqa: E402
from wise_tpu_torch.ops import block as K  # noqa: E402
from wise_tpu_torch.ops.build import (NVCC_FLAGS, SIGNATURES,  # noqa: E402
                                      find_nvcc)

CSRC = ROOT / "wise_tpu_torch" / "csrc"
OUT = ROOT / "build" / "bench"
#: build -> (threads a block, segments a group takes a tile, ring stages,
#: blocks an SM the registers are capped for)
VARIANTS = {
    "source": None,
    "reverse": "reverse",
    "t256-r2-s4": (256, 2, 4, 4),
    "t256-r4-s4": (256, 4, 4, 2),
    "t128-r4-s4": (128, 4, 4, 4),
    "t128-r2-s8": (128, 2, 8, 8),
}
FORWARD = "const int b = blockIdx.y,"
GROUPS = (0, 1, 2, 4, 8, 16)


def variant_source(spec) -> str:
    src = (CSRC / "block_kernels.cu").read_text()
    if spec is None:
        return src
    if spec == "reverse":
        assert src.count(FORWARD) == 1
        return src.replace(FORWARD,
                           "const int b = gridDim.y - 1 - blockIdx.y,")
    threads, rounds, stages, blocks = spec
    for name, v in (("kPoolThreads", threads), ("kPoolRounds", rounds),
                    ("kPoolStages", stages)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {v};", src)
        assert n == 1, name
    src, n = re.subn(r"__launch_bounds__\(kPoolThreads, \d+\)",
                     f"__launch_bounds__(kPoolThreads, {blocks})", src)
    assert n == 1
    return src


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs, libs = find_nvcc(), [], {}
    for name, spec in VARIANTS.items():
        cu = OUT / f"pooled_{name}.cu"
        cu.write_text(variant_source(spec))
        so = OUT / f"pooled_{name}.so"
        procs.append((name, so, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, so, p in procs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed ({name}):\n{out}")
        lib = ctypes.CDLL(str(so))
        for entry in ("wt_attention_pooled", "wt_attn_block_pooled"):
            fn = getattr(lib, entry)
            fn.argtypes = SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_ms(fn, calls: int = 20, kernel: str = "") -> float:
    """Device ms a call of ``fn``: the self time of every CUDA kernel it
    launches whose name holds ``kernel`` (torch.profiler), over ``calls``
    calls after 3."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel in e.key) / (
                   1e3 * calls)


def block_call(lib, s, rows, row):
    """A zero-argument call of the build's whole pooled block on seeded
    inputs at shape ``s`` (chip_smoke's stream dtype and scales)."""
    b, sp, d, h = s["b"], s["sp"], s["d"], s["heads"]
    g = torch.Generator(device="cuda").manual_seed(sp * d)
    dtype = torch.float32 if s["f32"] else torch.bfloat16

    def r(*shape, scale=0.02):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    x = r(b, sp, d, scale=1.0).to(dtype)
    ln_s, ln_b = 1.0 + r(d), r(d)
    bf = torch.bfloat16
    wqkv, bqkv = r(d, 3 * d, scale=d ** -0.5).to(bf), r(3 * d).to(bf)
    wo, bo = r(d, d, scale=d ** -0.5).to(bf), r(d).to(bf)
    y = torch.empty((b * sp, d), dtype=bf, device="cuda")
    kv = torch.empty((b * sp, 2 * d), dtype=bf, device="cuda")
    q = torch.empty((b, d), dtype=bf, device="cuda")
    att = torch.empty((b, d), dtype=bf, device="cuda")
    out = torch.empty((b, d), dtype=dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = [x.data_ptr(), int(s["f32"]), ln_s.data_ptr(), ln_b.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            None if rows is None else rows.data_ptr(), row, out.data_ptr(),
            y.data_ptr(), kv.data_ptr(), q.data_ptr(), att.data_ptr(), b, sp,
            d, h, sp, int(s["causal"]), stream]

    def call():
        err = lib.wt_attn_block_pooled(*args)
        if err:
            raise RuntimeError(f"wt_attn_block_pooled: {err}")

    return call


def main() -> int:
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    if not torch.cuda.is_available():
        print("bench_pooled_attention: needs a CUDA card", file=sys.stderr)
        return 2
    libs = build()
    for tag, s in BLOCK_SHAPES.items():
        if s.get("pooled", True) is False or s.get("only_attn"):
            continue
        b, sp, d, h = s["b"], s["sp"], s["d"], s["heads"]
        causal = s["causal"]
        hd = d // h
        g = torch.Generator(device="cuda").manual_seed(sp + d)
        bf = torch.bfloat16
        q = torch.randn((b, d), generator=g, device="cuda").to(bf)
        kv = torch.randn((b, sp, 2 * d), generator=g, device="cuda").to(bf)
        row = s.get("pool_row", 0)
        rows = (torch.tensor(DYN_ROWS, dtype=torch.int32, device="cuda")
                if causal else None)
        kept = (rows.long() + 1 if causal
                else torch.full((b,), sp, device="cuda"))
        want = K.plain_pooled_attention(q, kv, h, sp, rows, row, causal)
        q4 = q.view(b, h, 1, hd)
        k4 = kv[..., :d].view(b, sp, h, hd).transpose(1, 2)
        v4 = kv[..., d:].view(b, sp, h, hd).transpose(1, 2)
        mask = ((torch.arange(sp, device="cuda")[None, :]
                 < kept[:, None])[:, None, None] if causal else None)
        sdpa_ms = device_ms(lambda: sdpa(q4, k4, v4, attn_mask=mask))
        bound = 1e3 * (4 * d * float(kept.sum()) + 4 * b * d) / PEAK_BYTES
        att = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            fn = lib.wt_attention_pooled
            times = []
            for group in GROUPS:
                if group and h % group:
                    continue

                def call(fn=fn, group=group):
                    err = fn(q.data_ptr(), kv.data_ptr(), d,
                             None if rows is None else rows.data_ptr(), row,
                             att.data_ptr(), b, sp, h, sp, int(causal), group,
                             stream)
                    if err:
                        raise RuntimeError(f"{name} group {group}: {err}")

                call()
                torch.cuda.synchronize()
                check = K.output_agreement(att, want)
                if not check["ok"]:
                    raise SystemExit(f"{tag} {name} group {group}: {check}")
                times.append(f"{group}:{device_ms(call):.4f}")
            in_block = device_ms(block_call(lib, s, rows, row),
                                 kernel="attention_pooled_kernel")
            print(f"[pooled-bench] shape={tag} {b}x{sp}x{d} build={name} "
                  f"group_ms={','.join(times)} in_block_ms={in_block:.4f} "
                  f"sdpa_ms={sdpa_ms:.4f} bound_ms={bound:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
