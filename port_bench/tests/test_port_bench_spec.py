"""BENCHMARK.json against the benchmark's contract, every cell's files found
by name, and a cell and a metric added as files only."""

import json
import re

import pytest

from port_bench import harness
from port_bench.tests.tiny import REPO, tiny_checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH_KEYS = re.compile(r"(_dim|_rank)$|channels|heads|hidden|intermediate|latent")


def _spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) for p in spec["paths"])
    assert spec["paths"] == ["port_bench"]
    assert 1 <= len(spec["command"]) <= 32 and all(_one_line(w) for w in spec["command"])
    for word in spec["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in spec["paths"])
            assert (REPO / word).is_file()
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    s = _spec()["run_seconds"]
    assert 2 * (s + 60) + 24 * (14 * (s + 60) + 2 * 90) + 1200 <= 43200


def test_names_units_and_keys():
    spec = _spec()
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH_KEYS.search(k) for k in c["reduced"])
        assert c["file"].startswith("port_bench/") and (REPO / c["file"]).is_file()
    assert len({c["file"] for c in spec["configs"]}) == len(spec["configs"])
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _one_line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(spec["workloads"]) // 4)
    assert {w["config"] for w in spec["workloads"]} == {c["name"] for c in spec["configs"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in spec["end_to_end"] else {"layer", "moves"}
        assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in {e["name"] for e in spec["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_and_finds_its_files():
    spec = _spec()
    bench = REPO / "port_bench"
    for w in spec["workloads"]:
        _, cell, config, traffic = harness.load_cell(REPO, w["name"])
        assert config["name"] == cell["config"] and config["reduced"] == []
        assert (bench / "traffic" / f"{traffic['kind']}.py").is_file()
        assert harness.load_limits(bench, w["name"])
        e2e, per_layer = harness.cell_metrics(spec, w["name"])
        assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2
        assert per_layer
        for m in per_layer:
            assert callable(harness.load_reader(bench, m["name"]))
            for listed in m.get("workloads", []):
                reported = {e["name"] for e in harness.cell_metrics(spec, listed)[0]}
                assert m["moves"] in reported


def test_a_cell_and_a_metric_added_as_files_only(tmp_path):
    """A new configuration, mix, limits file, cell and per-layer metric, added
    as data and reader files to a copy, are read with no file edited."""
    root = tiny_checkout(tmp_path)
    bench = root / "port_bench"
    (bench / "layer_metrics" / "windows.sample.py").write_text(
        "def read(out, run):\n    return out.window_s\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "windows.sample", "unit": "s", "better": "lower",
                              "source": "host_clock", "layer": "window",
                              "moves": "sample_img_s", "workloads": ["tiny_base"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    _, cell, config, traffic = harness.load_cell(root, "tiny_base")
    assert config["net"]["channels"] == 32 and traffic["batch"] == 4
    _, per_layer = harness.cell_metrics(spec, "tiny_base")
    assert "windows.sample" in [m["name"] for m in per_layer]
    assert harness.load_reader(bench, "windows.sample")(
        type("O", (), {"window_s": 2.5})(), None) == 2.5
    with pytest.raises(SystemExit):
        harness.load_cell(root, "no_such_cell")
