#!/usr/bin/env python3
"""Time the Swin block's two kernels (wise_tpu_torch/csrc/swin_kernels.cu
``swin_attn_kernel`` and ``swin_mlp_kernel``, behind ``fused_swin_block`` and
``fused_window_attention``) on one CUDA card, whole and cut down, to see
where their time goes.

    python3 scripts/bench_swin_block.py [build ...]   # all builds, or these

At HTSAT's fused stages at batch 64 (stage 0 unshifted and shifted, stages
1 and 2 shifted) it prints a ``[swin_bench]`` line a stage and build with
each kernel's device ms (torch.profiler, self time, 5 calls after 2) under
``wt_swin_block`` (``attn_ms``, ``mlp_ms``) and under
``wt_window_attention`` (``wa_ms``: kernel A without LayerNorm and
residual). The builds are compiled from the source with nvcc into
build/bench/, all together; each cuts one part out of kernel A and one out
of kernel B (the two are timed apart, so a build serves both):

- ``full``: the source as it is;
- ``no_attn`` / ``no_gelu``: A without the attention middle (QK^T, the
  softmax, PV), B with h = fc1's output (no GELU);
- ``no_qkv`` / ``no_fc1``: A without the q, k, v products, B without fc1's;
- ``no_proj`` / ``no_fc2``: A without the out-projection's product, B
  without fc2's;
- ``no_bias`` / ``no_stream``: A's bias + mask table built without its
  loads, B with only the first weight chunk loaded;
- ``no_ln`` / ``-``: A without LN1;
- ``g1`` / ``g2`` / ``g3`` (and ``-``): A holding at most 1 or 2, or
  exactly 3 windows at once; ``gwin``: its group chosen for the most
  windows in flight an SM (CTAs an SM x G) instead of the most CTAs;
- ``regs255`` / ``regs128`` (and ``-``): A under 255 or 128 registers a
  thread (two or four CTAs an SM where shared memory allows).

A cut build computes a wrong answer; only its time is read. Needs nvcc and
one card.
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from wise_tpu_torch.models.clap.model import (  # noqa: E402
    relative_position_index, shift_attn_mask)
from wise_tpu_torch.ops.build import (NVCC_FLAGS, SIGNATURES,  # noqa: E402
                                      find_nvcc)
from wise_tpu_torch.ops.swin_attention import launched_array  # noqa: E402

CSRC = ROOT / "wise_tpu_torch" / "csrc"
OUT = ROOT / "build" / "bench"
#: (tag, windows, C, heads, n_win of the shift mask or None), batch 64
STAGES = [("stage0", 4096, 96, 4, None), ("stage0-shifted", 4096, 96, 4, 64),
          ("stage1-shifted", 1024, 192, 8, 16),
          ("stage2-shifted", 256, 384, 16, 4)]


def _cut(src: str, pattern: str, repl: str, regex: bool = False) -> str:
    n = len(re.findall(pattern, src)) if regex else src.count(pattern)
    if n == 0:
        raise SystemExit(f"the source no longer holds {pattern!r}")
    return re.sub(pattern, repl, src) if regex else src.replace(pattern,
                                                                repl)


def _drop_call(src: str, head: str) -> str:
    """Empty every statement that starts with ``head`` (up to its ';')."""
    if head not in src:
        raise SystemExit(f"the source no longer holds {head!r}")
    while head in src:
        i = src.index(head)
        src = src[:i] + ";" + src[src.index(";", i) + 1:]
    return src


def variants() -> dict:
    src = (CSRC / "swin_kernels.cu").read_text()
    start = src.index("        // S = Q K^T: the warp's Q fragments")
    end = src.index("        // att's columns of head h, rounded")
    no_attn = (src[:start] + "        float o[kChunks][4] = {};\n"
               + src[end:])
    return {
        "full": src,
        "no_attn+no_gelu": _cut(no_attn,
                                r"activation\((h\[4 \* j(?: \+ \d)?\] "
                                r"\+ b\d), kGelu\)", r"\1", regex=True),
        "no_qkv+no_fc1": _drop_call(_drop_call(_drop_call(
            src, "warp_mma<kChunks>(acc, ys"), "Wgmma<64>::mma(h, da, db)"),
            "wgmma_ss32(h, da, db)"),
        "no_proj+no_fc2": _drop_call(_drop_call(_drop_call(
            src, "warp_mma<kChunks>(acc, att"),
            "Wgmma<64>::mma(acc[q], da,"), "wgmma_ss32(tacc, da,"),
        "no_bias+no_stream": _cut(_cut(_cut(_cut(
            src, "            v[u] = __ldg(reinterpret_cast<const float4*>(bh) + tid +\n"
            "                         u * kSwinAttnThreads);",
            "            v[u] = make_float4(0.f, 0.f, 0.f, 0.f);"),
            "          if (mr) {\n#pragma unroll", "          if (false) {\n#pragma unroll"),
            "    if (ch >= chunks) return;", "    if (ch >= 1) return;"),
            "  auto load_wproj = [&](int ch) {\n",
            "  auto load_wproj = [&](int ch) {\n    if (ch >= 1) return;\n"),
        "no_ln": _cut(src, "    if (p.ln_s) {", "    if (false) {"),
        "g1": _cut(src, "for (int G = 1; G <= kSwinMaxGroup; ++G)",
                   "for (int G = 1; G <= 1; ++G)"),
        "g2": _cut(src, "for (int G = 1; G <= kSwinMaxGroup; ++G)",
                   "for (int G = 1; G <= 2; ++G)"),
        "gwin": _cut(src, "if (per >= best_per && per > 0) best_g = G, "
                     "best_per = per;",
                     "if (per * G > best_per * best_g) best_g = G, "
                     "best_per = per;"),
        "g3": _cut(src, "for (int G = 1; G <= kSwinMaxGroup; ++G)",
                   "for (int G = 3; G <= 3; ++G)"),
        "regs255": _cut(src, "__launch_bounds__(kSwinAttnThreads, 3)",
                        "__launch_bounds__(kSwinAttnThreads, 2)"),
        "regs128": _cut(src, "__launch_bounds__(kSwinAttnThreads, 3)",
                        "__launch_bounds__(kSwinAttnThreads, 4)"),
    }


def build(srcs: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs, libs = find_nvcc(), [], {}
    for i, (name, text) in enumerate(srcs.items()):
        cu, so = OUT / f"swin_{i}.cu", OUT / f"swin_{i}.so"
        cu.write_text(text)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
        libs[name] = so
    for p in procs:
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed:\n{out}")
    loaded = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        for fn in ("wt_swin_block", "wt_window_attention"):
            getattr(lib, fn).argtypes = SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def inputs(n, c, heads, n_win, seed=20):
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16

    def r(*shape, scale=0.02):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    idx = torch.from_numpy(relative_position_index(8).reshape(-1)).cuda()
    bias = r(225, heads, scale=1.0)[idx].reshape(64, 64, heads).permute(
        2, 0, 1).contiguous()
    mask = None
    if n_win:
        res = 8 * math.isqrt(n_win)
        mask = torch.from_numpy(shift_attn_mask(res, res, 8, 4)).cuda()
    return dict(
        x=r(n * 64, c, scale=1.0).to(bf), bias=bias, mask=mask,
        wqkv=r(c, 3 * c, scale=c ** -0.5).to(bf), bqkv=r(3 * c).to(bf),
        wo=r(c, c, scale=c ** -0.5).to(bf), bo=r(c).to(bf),
        ln=[1 + r(c), r(c), 1 + r(c), r(c)],
        wfc=r(c, 4 * c, scale=c ** -0.5).to(bf), bfc=r(4 * c).to(bf),
        wproj=r(4 * c, c, scale=(4 * c) ** -0.5).to(bf), bproj=r(c).to(bf))


def device_ms(fn, reps=5):
    """Self device ms a call of each CUDA kernel ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / (1e3 * reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_swin_block: needs a CUDA card", file=sys.stderr)
        return 2
    wanted = set(sys.argv[1:])
    libs = build({k: v for k, v in variants().items()
                  if not wanted or k in wanted or k == "full"})
    stream = torch.cuda.current_stream().cuda_stream
    counts = launched_array()   # the entries' launch counts, unread here
    launched = ctypes.addressof(counts)
    for tag, n, c, heads, n_win in STAGES:
        t = inputs(n, c, heads, n_win)
        m = n * 64
        out, o = (torch.empty(m, c, dtype=torch.bfloat16, device="cuda")
                  for _ in range(2))
        mask = t["mask"].data_ptr() if t["mask"] is not None else None
        ln = t["ln"]
        for name, lib in libs.items():
            def block(lib=lib):
                err = lib.wt_swin_block(
                    t["x"].data_ptr(), None, 0, ln[0].data_ptr(),
                    ln[1].data_ptr(), t["wqkv"].data_ptr(),
                    t["bqkv"].data_ptr(), t["wo"].data_ptr(),
                    t["bo"].data_ptr(), t["bias"].data_ptr(), mask,
                    n_win or 0, ln[2].data_ptr(), ln[3].data_ptr(),
                    t["wfc"].data_ptr(), t["bfc"].data_ptr(),
                    t["wproj"].data_ptr(), t["bproj"].data_ptr(),
                    out.data_ptr(), o.data_ptr(), None, None, None, None, n,
                    64, c, heads, 4 * c, launched, stream)
                if err:
                    raise SystemExit(f"{name}: cudaError {err}")

            def window(lib=lib):
                err = lib.wt_window_attention(
                    t["x"].data_ptr(), t["wqkv"].data_ptr(),
                    t["bqkv"].data_ptr(), t["wo"].data_ptr(),
                    t["bo"].data_ptr(), t["bias"].data_ptr(), mask,
                    n_win or 0, out.data_ptr(), None, None, n, 64, c, heads,
                    launched, stream)
                if err:
                    raise SystemExit(f"{name}: cudaError {err}")

            blk, wa = device_ms(block), device_ms(window)

            def part(d, key):
                return sum(v for k, v in d.items() if key in k)

            print(f"[swin_bench] stage={tag} build={name} "
                  f"attn_ms={part(blk, 'swin_attn_kernel'):.4f} "
                  f"mlp_ms={part(blk, 'swin_mlp_kernel'):.4f} "
                  f"wa_ms={part(wa, 'swin_attn_kernel'):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
