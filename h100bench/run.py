"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``), whose ``driver`` names the code that runs it
(``drivers/<driver>.py``); the compared numbers' limits are in
``limits/<cell>.json``, and each per-layer metric's reader in
``metrics/<metric>.py``. With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones, read from a
``torch.profiler`` trace of the window and the benchmark's own spans.

Needs a CUDA card (and as many as the cell asks for); exits with 2 and no
result without one. Exits with 3 and no result if JAX or the JAX package
was loaded. The last line of standard output is the result, a JSON object;
the last lines of standard error are the compared numbers, each beside its
limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "wise_tpu")


def steady_allocator() -> None:
    """Fix glibc's malloc thresholds for this process: mmap above 32 MiB,
    trim the heap above 1 GiB. With glibc's default dynamic threshold a
    process serves the ingest pipeline's per-frame copies (147 KB at 224
    px, 442 KB at 384) either from its heap or by a fresh mmap that
    page-faults each, as its allocation history happens to go; runs of one
    seed then spread by a quarter. Fixed, every run takes the heap."""
    import ctypes

    libc = ctypes.CDLL("libc.so.6")
    m_trim_threshold, m_mmap_threshold = -1, -3
    if not (libc.mallopt(m_mmap_threshold, 32 << 20)
            and libc.mallopt(m_trim_threshold, 1 << 30)):
        raise RuntimeError("mallopt refused the allocator's thresholds")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is forbidden, compared
    whole (``wise_tpu_torch`` is not ``wise_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name: str, root: Path = ROOT, bench: Path = BENCH):
    """(cell, its configuration, its traffic, the benchmark spec) from the
    checkout at ``root`` and the benchmark's data under ``bench``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (bench / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic, spec


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str, bench: Path = BENCH):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    mod_name = "h100bench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str, bench: Path = BENCH):
    path = bench / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100bench_driver_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(outcome, cell: dict, spec: dict, trace: bool,
               bench: Path = BENCH) -> dict:
    out = {}
    if not trace:
        for m in spec["end_to_end"]:
            if applies(m, cell["name"]):
                out[m["name"]] = {"value": outcome.end_to_end[m["name"]],
                                  "unit": m["unit"]}
        return out
    for m in spec["per_layer"]:
        if applies(m, cell["name"]):
            value = reader(m["name"], bench)(outcome.readings)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(outcome, cell, spec, trace: bool, device: dict,
                bench: Path = BENCH) -> dict:
    """The result: ``checks`` last, each compared number with its limit."""
    correct = (not outcome.fault and outcome.failed == 0
               and all(c.passes for c in outcome.checks))
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed,
            "metrics": metrics_of(outcome, cell, spec, trace, bench),
            "device": device}
    tr = outcome.readings.get("trace")
    if trace and tr is not None:
        line["device"] = dict(device, busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tr.device_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    return line


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"this cell needs {n} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        raise SystemExit(2)


def execute(args, device, root: Path = ROOT, bench: Path = BENCH):
    """Run the cell on ``device`` (the card, or a test's CPU) and return
    (outcome, cell, spec)."""
    from h100bench.harness import Ctx, limits_of

    cell, config, traffic, spec = load_cell(args.workload, root, bench)
    tmp = Path(tempfile.mkdtemp(prefix="h100bench-"))
    try:
        ctx = Ctx(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=device, config=config, traffic=traffic,
                  limits=limits_of(cell["name"], bench), tmp=tmp,
                  t_start=T_START)
        os.environ["WISE_CHECKPOINT_DIR"] = str(tmp / "no-checkpoints")
        outcome = driver(traffic["driver"], bench).run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return outcome, cell, spec


def main(argv=None) -> int:
    steady_allocator()
    args = parse(argv)
    # a library the port loads must not bring JAX in on its own
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    cell, _, _, _ = load_cell(args.workload)
    require_cards(cell["chips"])
    import torch

    device = torch.device("cuda", 0)
    outcome, cell, spec = execute(args, device)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell["chips"],
            "memory_peak_bytes": outcome.memory_peak_bytes}
    line = result_line(outcome, cell, spec, bool(args.trace), info)
    if outcome.fault:
        print(f"fault: {outcome.fault}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
