#!/usr/bin/env python3
"""Compare the SASS of the kernels whose names match a pattern in two builds
of the port's kernel library (``cuobjdump -sass``).

    python3 scripts/sass_diff.py OLD.so NEW.so topk_span_kernel [SHOW]

Prints, for each matching function of either build, its instruction count in
each and the number of lines that differ, and the total last; with SHOW, the
first SHOW differing lines of each function too. The lines are compared as
cuobjdump prints them (their ``/*0000*/`` addresses are offsets in the
function), with runs of blanks taken as one, since cuobjdump pads its
columns to the widest line of the whole dump, and with the anonymous
namespace's tag left out of the names. Exits 1 if a function is in one build
alone or any line differs.
"""

from __future__ import annotations

import difflib
import re
import subprocess
import sys


def functions(so: str, pattern: str) -> dict:
    out = subprocess.run(["cuobjdump", "-sass", so], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # the anonymous namespace's tag differs from build to build
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", m.group(1))
            name = name if re.search(pattern, name) else None
            if name:
                funcs[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            # cuobjdump pads the columns to the widest line of its dump
            funcs[name].append(" ".join(line.split()))
    return funcs


def main(argv) -> int:
    old, new, pattern = argv[1:4]
    show = int(argv[4]) if len(argv) > 4 else 0
    a, b = functions(old, pattern), functions(new, pattern)
    total = 0
    for name in sorted(set(a) | set(b)):
        if name not in a or name not in b:
            print(f"{name}: only in {'new' if name in b else 'old'}")
            total += len(a.get(name, b.get(name)))
            continue
        lines = [d for d in difflib.unified_diff(a[name], b[name], n=0,
                                                 lineterm="")
                 if d[:1] in ("+", "-") and d[:3] not in ("+++", "---")]
        diff = len(lines)
        for d in lines[:show]:
            print("   ", d)
        print(f"{name}: {len(a[name])} / {len(b[name])} lines, "
              f"{diff} differ")
        total += diff
    names = set(a) | set(b)
    print(f"sass_diff functions={len(names)} differing_lines={total}")
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
