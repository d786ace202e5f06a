"""The plain reference against the program (`vivid_tpu_torch`) at tiny
widths on the CPU, and the harness driven end to end at those widths: sound
runs come out correct, the fp8 control reads well above the program, and
each fault that a cell can have makes `correct` false. (A test may import
both the reference and the program; the reference imports nothing of it.)"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_bench import harness, program
from port_bench.reference.model import NetSpec, Precond
from port_bench.tests.tiny import REPO, TINY_NET, TINY_SR, tiny_checkout
from port_bench.weights import seeded_state


def _spec(config, key, tiny, **over):
    d = json.loads((REPO / "port_bench" / "configs" / config).read_text())
    net = dict(d[key], **tiny, **over)
    return NetSpec.from_json(net), d


CASES = {"base": ("vivid-base.json", "net", TINY_NET),
         "uncond": ("vivid-base.json", "guide", TINY_NET),
         "sr": ("vivid-sr.json", "net", TINY_SR)}


def _inputs(spec, b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = spec.resolution
    return (torch.rand(b, spec.num_sources, r, r, 3, generator=g) * 2 - 1,
            torch.randn(b, r, r, 3, generator=g) * 2, torch.tensor([0.3, 4.0])[:b],
            torch.randn(b, spec.num_sources, 20, generator=g),
            torch.randn(b, r, r, 3, generator=g) if spec.super_res else None,
            torch.randn(b, r, r, 3, generator=g) if spec.super_res else None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_program(case):
    spec, _ = _spec(*CASES[case], use_bf16=False)
    port = program.build_net(spec, 7, "net", "cpu").net
    ref = Precond(spec)
    ref.load_state_dict(seeded_state(ref, 7, "net", "cpu"))
    src, x, sigma, geo, cond, noise = _inputs(spec)
    with torch.no_grad():
        d_ref, lv_ref = ref(src, x, sigma, geo, cond, noise, return_logvar=True)
        d_port, lv_port = port(None if spec.uncond else src, x, sigma,
                               None if spec.uncond else geo, return_logvar=True,
                               conditioning_image=cond, cond_noise=noise)
    torch.testing.assert_close(d_port, d_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lv_port, lv_ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("bench"))


def _run(root, cell, fault=None, control=None):
    return harness.run_cell(root, cell, 2 ** 31 + 12345, 0.5, False, device="cpu",
                            fault=fault, control=control)


@pytest.mark.parametrize("cell", ["tiny_base", "tiny_sr"])
def test_sampling_runs_correct_and_the_control_reads_far_above(checkout, cell):
    result, out, control = _run(checkout, cell, control="fp8")
    assert result["correct"], result["checks"]
    assert result["checks"]["start_gap"]["value"] == 0
    assert out.control["step_gap"] > 3 * result["checks"]["step_gap"]["value"]
    assert set(result["metrics"]) == {"sample_img_s", "setup_s"}
    assert list(result)[-1] == "checks"
    # the control, judged in the program's place by the harness's own line, is not correct
    assert not control["correct"]
    assert control["checks"]["step_gap"]["value"] == out.control["step_gap"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in ("tiny_base", "tiny_sr")
                                        for f in ("unchanged", "half", "altered")])
def test_sampling_faults_are_not_correct(checkout, cell, fault):
    result, _, _ = _run(checkout, cell, fault=fault)
    assert not result["correct"]


def test_no_card_no_result(checkout):
    """Without a CUDA card the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "tiny_base",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=checkout,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's folder
    the command fails (no program to measure) and prints no result."""
    import shutil
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "sr_sample_b32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.card
@pytest.mark.parametrize("cell", ["sr_sample_b32"])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 7), "--seconds", "1", "--trace", "1"], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["breakdown"]["device_ops"]
    for name, m in result["metrics"].items():
        if "mfu" in name or "roofline" in name:
            assert 0 < m["value"] <= 100


def test_seeded_weights_repeat():
    spec, _ = _spec(*CASES["base"])
    with torch.device("meta"):
        shapes = Precond(spec)
    a = seeded_state(shapes, 5, "net", "cpu")
    b = seeded_state(shapes, 5, "net", "cpu")
    c = seeded_state(shapes, 6, "net", "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["unet.out_conv.weight"], c["unet.out_conv.weight"])
    ph = a["unet.emb_fourier.phases"]
    assert float(ph.min()) >= 0 and float(ph.max()) <= 2 * np.pi
