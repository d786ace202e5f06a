"""The port's tools against their `tools/` twins on the CPU: the overfit
proof's evaluation and gates (with C-ref-11, the JAX gate that passes a
rising negative loss, pinned), the memory reports' configurations and their
refusal without a card, and the protocol snapshots."""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from vivid_tpu.diffusion import sampler as jsampler
from vivid_tpu.nn import precond as jprecond
from vivid_tpu_torch.compat.from_jax import from_jax
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.tools import guided_mem, make_protocol_snapshots, mem_report, overfit_smoke
from vivid_tpu_torch.train.snapshots import load_snapshot

from test_torch_repairs import TINY, _params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name, monkeypatch):
    """tools/<name>.py, loaded by path (it has no package)."""
    monkeypatch.setenv("VIVID_COMP_CACHE", "0")
    monkeypatch.syspath_prepend(REPO)
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Captured(Exception):
    pass


def _jax_configs(monkeypatch, run, count):
    """The first `count` PrecondConfigs that `run()` makes in vivid_tpu;
    `run` is stopped at the last of them."""
    seen, real = [], jprecond.PrecondConfig

    def record(**kw):
        seen.append(real(**kw))
        if len(seen) == count:
            raise _Captured
        return seen[-1]

    monkeypatch.setattr(jprecond, "PrecondConfig", record)
    with pytest.raises(_Captured):
        run()
    return seen


def _same_config(ours, theirs):
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


# -- overfit_smoke -----------------------------------------------------------------

def test_loss_gate_fails_a_rising_negative_loss():
    """C-ref-11: the recorded TPU run's head third is -0.95; a tail third of
    -0.70 means the loss rose by 0.25. The JAX gate tail < 0.7 head passes
    it; the port's tail < head - 0.3 |head| does not, and is the JAX gate
    for a positive loss."""
    head, tail = -0.95, -0.70
    assert tail < 0.7 * head                              # the JAX tool's gate
    assert not overfit_smoke.loss_gate_passes(head, tail)
    assert overfit_smoke.loss_gate_passes(-0.95, -1.30)
    for head, tail in ((0.8, 0.5), (0.8, 0.6), (1.0, 0.7)):
        assert overfit_smoke.loss_gate_passes(head, tail) == (tail < 0.7 * head)


def test_overfit_evaluation_matches_jax(monkeypatch):
    """The evaluation (16 Heun steps from sigma 2) and its PSNR on the same
    weights and noise as the JAX tool's `sample` and `psnr`."""
    jtool = _jax_tool("overfit_smoke", monkeypatch)
    cfg = jprecond.PrecondConfig(img_resolution=16, **TINY)
    params = _params(cfg, 1)
    rng = np.random.RandomState(7)
    src = rng.uniform(-1, 1, (2, 2, 16, 16, 3)).astype(np.float32)
    geo = rng.randn(2, 2, 20).astype(np.float32)
    noise = rng.randn(2, 16, 16, 3).astype(np.float32)
    tgt = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)

    @jax.jit
    def sample(p, s, g, n):
        den = jsampler.make_denoiser(p, cfg, src=s, geometry=g)
        return jsampler.edm_sampler(den, n, num_steps=16, sigma_max=2.0)

    want = np.asarray(sample(params, src, geo, noise))
    net = NVPrecond(PrecondConfig(**dataclasses.asdict(cfg)))
    net.load_state_dict(from_jax(params), strict=True)
    got, db = overfit_smoke.evaluate(net.eval(), *map(torch.from_numpy, (src, geo, noise, tgt)))
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-4
    assert abs(db - jtool.psnr(want, tgt)) <= 0.05
    assert overfit_smoke.psnr(want, tgt) == pytest.approx(jtool.psnr(want, tgt), abs=1e-9)


def test_overfit_run_writes_its_json_and_fails_its_gates(tmp_path):
    out = tmp_path / "overfit.json"
    rc = overfit_smoke.main(["--steps", "3", "--ch", "16", "--imsize", "16", "--batch", "4",
                             "--device", "cpu", "--out", str(out)])
    result = json.load(open(out))
    assert rc == 1
    assert set(result) == {"steps", "batch", "ch", "imsize", "loss_curve", "loss_head_third",
                           "loss_tail_third", "psnr_before_db", "psnr_after_db",
                           "psnr_src_floor_db", "psnr_after_ema_db", "psnr_after_raw_db",
                           "wall_s", "device"}
    assert [i for i, _ in result["loss_curve"]] == [0, 2] and result["device"] == "cpu"


def test_overfit_defaults_match_jax(tmp_path, monkeypatch):
    """The JAX tool's model config at its defaults, captured as its main
    builds it, and the port's defaults."""
    import tempfile
    jtool = _jax_tool("overfit_smoke", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["overfit_smoke"])
    monkeypatch.setattr(tempfile, "mkdtemp", lambda **kw: str(tmp_path))
    from vivid_tpu.data import scenes as jscenes
    monkeypatch.setattr(jscenes, "make_synthetic_dataset", lambda *a, **k: None)
    from vivid_tpu.data import collate as jcollate

    class NoLoader:
        def __init__(self, *a, **k):
            pass
    monkeypatch.setattr(jcollate, "BatchLoader", NoLoader)
    monkeypatch.setattr(jscenes, "SceneDataset", lambda *a, **k: [])
    (theirs,) = _jax_configs(monkeypatch, jtool.main, 1)
    _same_config(overfit_smoke.model_config(), theirs)
    defaults = vars(overfit_smoke.parser().parse_args([]))
    assert {k: defaults[k] for k in ("steps", "batch", "ch", "imsize")} == dict(
        steps=2000, batch=16, ch=64, imsize=32)


# -- mem_report and guided_mem -----------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--sr"], ["--flagship"], ["--ch", "96"],
                                   ["--sr", "--remat", "true"], ["--remat", "false"]])
def test_mem_report_configs_match_jax(flags, monkeypatch):
    jtool = _jax_tool("mem_report", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["mem_report", *flags])
    (theirs,) = _jax_configs(monkeypatch, jtool.main, 1)
    ch = int(flags[flags.index("--ch") + 1]) if "--ch" in flags else 64
    remat = flags[flags.index("--remat") + 1] if "--remat" in flags else "save_dots"
    ours = mem_report.build_config(ch, mem_report.parse_remat(remat), "--sr" in flags,
                                   "--flagship" in flags)
    _same_config(ours, theirs)


@pytest.mark.parametrize("ch", [64, 128])
def test_guided_mem_configs_match_jax(ch, monkeypatch):
    jtool = _jax_tool("guided_mem", monkeypatch)
    theirs = _jax_configs(monkeypatch, lambda: jtool.report(ch, 32), 2)
    for a, b in zip(guided_mem.configs(ch), theirs):
        _same_config(a, b)


def test_memory_reports_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool, argv in ((mem_report, ["--batch", "1"]), (guided_mem, ["--batches", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tool.main(argv)
    with pytest.raises(ValueError, match="needs a card"):
        mem_report.report(mem_report.build_config(16), 1, device="cpu")
    with pytest.raises(ValueError, match="needs a card"):
        guided_mem.report(16, 1, device="cpu")


# -- make_protocol_snapshots -------------------------------------------------------

def test_protocol_configs_match_jax_and_write_tiny_snapshots(tmp_path, monkeypatch):
    jtool = _jax_tool("make_protocol_snapshots", monkeypatch)
    (tmp_path / "jax" / "scenes256").mkdir(parents=True)
    monkeypatch.setattr(sys, "argv", ["make_protocol_snapshots", "--outdir",
                                      str(tmp_path / "jax")])
    theirs = _jax_configs(monkeypatch, jtool.main, 3)
    bench_serve = sys.modules["tools.bench_serve"]
    ours = make_protocol_snapshots.protocol_configs()
    for (cfg, _), want in zip(ours.values(), theirs):
        _same_config(cfg, want)
    monkeypatch.undo()
    _same_config(ours["sr"][0], bench_serve.sr_config("log"))
    assert [seed for _, seed in ours.values()] == [0, 1, 2]

    tiny = make_protocol_snapshots.protocol_configs(channels=16, sr_channels=16)
    paths = make_protocol_snapshots.write_snapshots(str(tmp_path / "port"), tiny)
    for name, (cfg, _) in tiny.items():
        snap = load_snapshot(paths[name])
        assert dataclasses.asdict(snap.cfg) == dataclasses.asdict(cfg), name
    assert make_protocol_snapshots.write_snapshots(str(tmp_path / "port"), tiny) == paths
