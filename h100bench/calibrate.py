"""Readings from which the limits of a cell's compared numbers are set.

    python3 h100bench/calibrate.py --workload <cell> --seeds 12 \
        --first <seed> [--controls 3] [--seconds 3] [--leaves]

In one process, on the card: the program's readings over ``--seeds`` seeds
(each a run of the cell's driver with a short window), then the control's
over ``--controls`` seeds (the reference in float8 linear layers in the
program's place; for a training cell also the planted faults: the loss over
half of each batch, a step that leaves the masters unchanged). One JSON
line a reading; the last line sums up: the largest program reading and the
smallest control reading of each number. ``--leaves`` adds, for a training
cell, the leaves that read the largest gaps.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--leaves", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from h100bench import run as R
    from h100bench.harness import Ctx, limits_of

    R.steady_allocator()
    R.require_cards(1)
    cell, config, traffic, _ = R.load_cell(args.workload)
    drv = R.driver(traffic["driver"])
    device = torch.device("cuda", 0)
    prog, ctrl = {}, {}

    def ctx_for(seed, tmp):
        return Ctx(seed=seed, seconds=args.seconds, trace=False,
                   device=device, config=config, traffic=traffic,
                   limits=limits_of(cell["name"]), tmp=tmp,
                   t_start=time.perf_counter())

    for i in range(args.seeds):
        seed = args.first + 7919 * i
        tmp = Path(tempfile.mkdtemp(prefix="h100bench-cal-"))
        os.environ["WISE_CHECKPOINT_DIR"] = str(tmp / "no-checkpoints")
        t0 = time.perf_counter()
        try:
            out = drv.run(ctx_for(seed, tmp))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        row = {c.name: c.value for c in out.checks}
        for k, v in row.items():
            prog[k] = max(prog.get(k, v), v)
        line = {"seed": seed, "program": row, "s": time.perf_counter() - t0,
                "end_to_end": out.end_to_end}
        if args.leaves and "compared" in out.readings:
            c = out.readings["compared"]
            line["leaves"] = drv.leaf_gaps(c["program"], c["ref"])
        print(json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()
    for i in range(args.controls):
        seed = args.first + 104729 + 7919 * i
        t0 = time.perf_counter()
        tmp = Path(tempfile.mkdtemp(prefix="h100bench-cal-"))
        try:
            ctx = ctx_for(seed, tmp)
            if traffic["driver"] == "ingest":
                got = {"control_fp8": drv.control(ctx, traffic["sample"])}
            else:
                got = drv.control(ctx)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for kind, row in got.items():
            for k, v in row.items():
                key = f"{kind}.{k}"
                ctrl[key] = min(ctrl.get(key, v), v)
        print(json.dumps({"seed": seed, "control": got,
                          "s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell["name"], "program_max": prog,
                      "control_min": ctrl,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
