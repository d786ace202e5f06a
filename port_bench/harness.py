"""Runs one cell of BENCHMARK.json once and prints its result line.

Everything that belongs to one cell is found by name:
  * the cell's configuration, `configs/<config>.json` (the file that
    BENCHMARK.json names);
  * its traffic mix, `traffic/<traffic>.json`, whose `kind` names the module
    that drives it, `traffic/<kind>.py`;
  * the limits of the numbers its correctness check compares,
    `limits/<workload>.json`;
  * each per-layer metric's reader, `layer_metrics/<metric>.py`.

A run: set-up (inputs and weights from the seed, one warm call), a window of
`--seconds` of whole batches or steps, with `--trace 1` a profiled slice
after it, the program's state freed, and the comparison with the plain
reference. The result is the last line of standard output; the compared
numbers, each beside its limit, are the last lines of standard error.
"""

import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Callable, Dict, Optional

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vivid_tpu")
BENCH_DIR = Path(__file__).resolve().parent


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


@dataclass
class Run:
    """One run of one cell."""
    root: Path                  # the checkout
    workload: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: Path
    t_start: float
    control: Optional[str] = None      # "fp8": also judge the lower-precision control
    fault: Optional[str] = None        # a planted fault (the harness's own tests)

    @property
    def bench(self) -> Path:
        return self.root / "port_bench"


@dataclass
class Outcome:
    """What a traffic kind hands back."""
    setup_s: float
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, float]
    unit: str                         # "eval" | "step"
    units: int                        # evaluations or steps in the window
    window_s: float
    flops_per_unit: float             # model operations, from the configuration's shapes
    attn_per_unit: list               # counts.model.AttnCall of one unit
    memory_peak_bytes: int
    slice: object = None              # tracing.Slice of the traced run
    launches_per_unit: Dict[str, float] = field(default_factory=dict)
    control: Dict[str, float] = field(default_factory=dict)   # the control's compared numbers


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(root: Path, workload: str):
    """(BENCHMARK.json, the cell, its configuration, its traffic mix)."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "port_bench" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return spec, cell, config, traffic


def cell_metrics(spec: dict, workload: str):
    """(end-to-end metrics, per-layer metrics) that this cell reports."""
    def applies(m, reported=None):
        if "workloads" in m:
            return workload in m["workloads"]
        return reported is None or m["moves"] in reported
    e2e = [m for m in spec["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if applies(m, names)]
    return e2e, per_layer


def load_reader(bench: Path, name: str) -> Callable:
    """`read(outcome, run)` of layer_metrics/<name>.py."""
    path = bench / "layer_metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def load_limits(bench: Path, workload: str) -> Dict[str, float]:
    with open(bench / "limits" / f"{workload}.json") as f:
        return json.load(f)["limits"]


def forbidden_loaded():
    """Top-level names of loaded modules that the benchmark's process must not
    hold, compared whole (`vivid_tpu_torch` is not `vivid_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def execute(run: Run) -> Outcome:
    """Drive the cell's traffic kind (traffic/<kind>.py)."""
    kind = importlib.import_module(f"port_bench.traffic.{run.traffic['kind']}")
    return kind.run(run)


def result_line(run: Run, spec: dict, out: Outcome, limits: Dict[str, float]):
    """(the result object, correct) of a finished run."""
    e2e, per_layer = cell_metrics(spec, run.workload)
    values = dict(out.e2e, setup_s=out.setup_s)
    metrics = {}
    if run.trace:
        for m in per_layer:
            v = load_reader(run.bench, m["name"])(out, run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] not in values:
                raise RuntimeError(f"the {run.traffic['kind']} traffic gives no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    missing = sorted(set(limits) ^ set(out.checks))
    if missing:
        raise RuntimeError(f"compared numbers and limits differ: {missing}")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in out.checks.items()}
    correct = (out.failed == 0 and out.attempted > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    import torch
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                       else "cpu"),
              "count": int(run.cell["chips"]), "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": device}
    if run.trace and out.slice is not None:
        device["busy_s"] = out.slice.busy_s
        device["window_s"] = out.slice.window_s
        result["breakdown"] = out.slice.breakdown()
    result["checks"] = checks
    return result, correct


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device=None, t_start: Optional[float] = None, control: Optional[str] = None,
             fault: Optional[str] = None):
    """Run one cell once; returns (result object, outcome, the control's
    result object). With `control`, the control's numbers are put in the
    program's place and judged by the same limits (None where it gave no
    number: it has failed). `device` None takes cuda:0 and refuses to run
    without enough cards."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    spec, cell, config, traffic = load_cell(root, workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            raise SystemExit(f"{workload} needs {cell['chips']} CUDA card(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda:0"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    limits = load_limits(root / "port_bench", workload)
    with tempfile.TemporaryDirectory(prefix="port_bench_") as tmp:
        run = Run(root=root, workload=workload, cell=cell, config=config, traffic=traffic,
                  seed=seed, seconds=seconds, trace=trace, device=device, tmp=Path(tmp),
                  t_start=t_start, control=control, fault=fault)
        out = execute(run)
        result, _ = result_line(run, spec, out, limits)
        judged = None
        if control and set(out.control) == set(limits):
            judged, _ = result_line(run, spec, replace(out, checks=out.control), limits)
    return result, out, judged


def main(argv=None, t_start: Optional[float] = None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = BENCH_DIR.parent
    seed = args.seed % (1 << 63)
    limit = power_limit()
    if limit:
        say(f"card: {limit}")
    result, out, _ = run_cell(root, args.workload, seed, args.seconds, bool(args.trace),
                              t_start=t_start)
    if out.launches_per_unit:
        print(f"launches per {out.unit}: " + json.dumps(out.launches_per_unit), flush=True)
    bad = forbidden_loaded()
    if bad:
        say(f"refused: the benchmark's process holds {bad}")
        return 3
    for name, c in result["checks"].items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def bench_environment(root: Path):
    """Build and kernel caches at fixed paths inside the checkout, and no JAX
    pulled in by a library."""
    cache = root / "build" / "port_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
