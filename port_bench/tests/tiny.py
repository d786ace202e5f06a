"""A temporary checkout of the benchmark with tiny cells beside the real
ones: the same files, tiny configurations, mixes and limits added as data
files only, and the program linked in. Runs on the CPU in seconds."""

import json
import os
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_NET = dict(resolution=32, channels=32, channel_mult=[1, 2], num_blocks=1,
                attn_resolutions=[16], extra_attn=None, channels_per_head=32)
TINY_SR = dict(resolution=64, channels=32, channel_mult=[1, 2], num_blocks=1,
               attn_resolutions=[], extra_attn=1, channels_per_head=32)
SAMPLE_LIMITS = {"start_gap": 0, "step_gap": 4.0}


def _write(path: Path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def tiny_checkout(tmp: Path) -> Path:
    """A checkout under `tmp` holding the benchmark, BENCHMARK.json with
    two tiny cells added (tiny_base, tiny_sr), and a link to the program."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / "vivid_tpu_torch", root / "vivid_tpu_torch")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = root / "port_bench"
    base = json.loads((bench / "configs" / "vivid-base.json").read_text())
    for key in ("net", "guide"):
        base[key].update(TINY_NET)
    base["sampling"]["num_steps"] = 4
    sr = json.loads((bench / "configs" / "vivid-sr.json").read_text())
    sr["net"].update(TINY_SR)
    sr["sampling"]["num_steps"] = 4
    _write(bench / "configs" / "tiny-base.json", base)
    _write(bench / "configs" / "tiny-sr.json", sr)
    _write(bench / "traffic" / "tiny_sample.json",
           {"kind": "sample", "batch": 4, "scenes": 6, "check_batches": 2})
    spec["configs"] += [
        {"name": "tiny-base", "source": "tiny", "file": "port_bench/configs/tiny-base.json",
         "reduced": [], "why": "tiny"},
        {"name": "tiny-sr", "source": "tiny", "file": "port_bench/configs/tiny-sr.json",
         "reduced": [], "why": "tiny"}]
    for name, config in (("tiny_base", "tiny-base"), ("tiny_sr", "tiny-sr")):
        spec["workloads"].append({"name": name, "config": config, "traffic": "tiny_sample",
                                  "chips": 1, "why": "tiny"})
        _write(bench / "limits" / f"{name}.json", {"limits": SAMPLE_LIMITS})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and "sample_img_s" in (m["name"], m.get("moves")):
                m["workloads"].append(name)
    _write(root / "BENCHMARK.json", spec)
    return root
