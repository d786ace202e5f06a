"""Readings that the limits of a cell's correctness check are set from, on
the card at the cell's own size, many seeds in one process:

    python3 port_bench/controls.py --workload <name> --seeds 1,2,3 --seconds 1 \
        [--control-seeds 1,2] [--trace-seeds 4] [--faults unchanged,half,altered]

For each seed, one run of the cell (set-up, a window of --seconds, the
comparison). On the control seeds the lower-precision control is read on the
same states, the plain reference with every product's inputs rounded to fp8
(per-tensor scaled e4m3), and its numbers are put in the program's place and
judged by the cell's limits through the harness's own result line. Each
fault of --faults is planted in the program's net on the first seed, and the
run is judged as any other. One JSON line a run: its kind (`program`,
`control` or the fault), whether it came out correct, and each compared
number. The benchmark's own runs never run the control or a fault.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "port_bench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _row(workload, seed, kind, result, **extra):
    row = {"workload": workload, "seed": seed, "kind": kind,
           "correct": None if result is None else result["correct"],
           "checks": None if result is None else {k: c["value"]
                                                  for k, c in result["checks"].items()}}
    row.update(extra)
    print(json.dumps(row), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--trace-seeds", default="", help="seeds run with --trace 1 as well")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control-seeds", default=None,
                   help="the seeds whose control is judged (default: all of --seeds)")
    p.add_argument("--faults", default="", help="faults planted on the first seed")
    args = p.parse_args(argv)
    seeds = _seeds(args.seeds)
    traced = set(_seeds(args.trace_seeds))
    controlled = set(seeds) if args.control_seeds is None else set(_seeds(args.control_seeds))
    for seed in seeds + sorted(traced):
        t = time.perf_counter()
        result, out, control = harness.run_cell(
            ROOT, args.workload, seed, args.seconds, seed in traced, t_start=t,
            control="fp8" if seed in controlled else None)
        extra = dict(trace=seed in traced, metrics=result["metrics"],
                     memory_peak_bytes=result["device"]["memory_peak_bytes"],
                     units=out.units, window_s=out.window_s, run_s=time.perf_counter() - t)
        if seed in traced:
            extra.update(device=result["device"], breakdown=result.get("breakdown"),
                         launches_per_unit=out.launches_per_unit)
        _row(args.workload, seed, "program", result, **extra)
        if seed in controlled:
            # no number from the control is a failed control
            _row(args.workload, seed, "control", control)
    for fault in args.faults.split(",") if args.faults else []:
        t = time.perf_counter()
        result, _, _ = harness.run_cell(ROOT, args.workload, seeds[0], args.seconds, False,
                                        t_start=t, fault=fault)
        _row(args.workload, seeds[0], fault, result, run_s=time.perf_counter() - t)
    return 0


if __name__ == "__main__":
    harness.bench_environment(ROOT)
    sys.exit(main())
