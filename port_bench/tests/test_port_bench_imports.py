"""What the benchmark's process may hold: no JAX, no JAX package (top-level
names compared whole), and a reference that imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from port_bench import harness
from port_bench.tests.tiny import REPO

BENCH = REPO / "port_bench"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vivid_tpu_torch_lookalike", sys)
    assert "vivid_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "vivid_tpu.sub", sys)
    assert harness.forbidden_loaded() == ["vivid_tpu"]


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("vivid_tpu_torch", "vivid_tpu", "jax", "jaxlib", "flax"), path
            assert top in ("torch", "numpy", "math", "dataclasses", "typing", "port_bench"), \
                (path, name)
            if top == "port_bench":
                assert name.startswith("port_bench.reference"), (path, name)


def test_no_benchmark_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "vivid_tpu"), (path, name)


def test_run_import_graph_holds_no_jax():
    """Everything run.py and the traffic kinds load, the program's sampling
    entry with it, in a fresh process."""
    code = (
        "import sys; sys.argv = ['run.py']\n"
        "import runpy; runpy.run_path('port_bench/run.py', run_name='not_main')\n"
        "import port_bench.traffic.sample, port_bench.controls\n"
        "import vivid_tpu_torch.generate\n"
        "from port_bench import harness\n"
        "bad = harness.forbidden_loaded()\n"
        "ref = [m for m in sys.modules if m.split('.')[0] == 'vivid_tpu_torch']\n"
        "print('BAD', bad, 'PROGRAM', bool(ref))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD [] PROGRAM True" in out.stdout


def test_reference_loads_without_the_program():
    code = ("import sys\n"
            "import port_bench.reference.model, port_bench.reference.sampling\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'vivid_tpu_torch', 'vivid_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("[]")
