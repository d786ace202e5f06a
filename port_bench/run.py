"""Run one cell of the benchmark once:

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(`python3 -m port_bench.run ...` from the checkout's root does the same.)
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Run as a script, the interpreter puts this folder first on the path, where
# its modules would shadow others of the same name: the checkout goes there.
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "port_bench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    harness.bench_environment(ROOT)
    sys.exit(harness.main(t_start=T0))
