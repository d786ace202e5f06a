"""The port's last entry points and tools on the CPU at tiny widths:
`core/trace.py`, the operation counts (`core/summary.py` `flops_analysis`
and the kernels' tallies), `--debug-nans`, the root wrappers and scripts,
and `examples/quickstart_torch.py`, against vivid_tpu where it has the same
function."""

import importlib
import json
import os
import sys
import tempfile
import tomllib

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from vivid_tpu_torch.core.consistency import debug_nans
from vivid_tpu_torch.core.summary import flops_analysis
from vivid_tpu_torch.core.trace import span, trace
from vivid_tpu_torch.data import scenes
from vivid_tpu_torch.kernels import flash, mp_fused
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.tools import fused_conv_lab, nomax_attn_lab
from vivid_tpu_torch.train import loop

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = dict(img_resolution=16, model_channels=16, channel_mult=(1, 2), num_blocks=1,
           attn_resolutions=(8,), channels_per_head=8, use_bf16=False, remat=True)


# -- core/trace.py ------------------------------------------------------------------

def test_trace_writes_the_annotated_range(tmp_path):
    @span("vivid_range")
    def work(x):
        return (x @ x).sum()

    with trace(str(tmp_path), enabled=True) as prof:
        work(torch.randn(8, 8))
    names = {e["name"] for e in json.load(open(prof.trace_file))["traceEvents"] if "name" in e}
    assert os.path.dirname(prof.trace_file) == str(tmp_path)
    assert "vivid_range" in names
    with trace(str(tmp_path / "off"), enabled=False) as off:
        assert off is None
    assert not os.path.exists(tmp_path / "off")


# -- operation counts --------------------------------------------------------------

def test_flops_analysis_of_a_matmul_matches_jax():
    import jax.numpy as jnp
    from vivid_tpu.core.summary import flops_analysis as jflops
    a = np.random.RandomState(0).randn(24, 24).astype(np.float32)
    got = flops_analysis(lambda x: x @ x, torch.from_numpy(a))
    assert got["flops"] == got["operators"] == jflops(lambda x: x @ x, jnp.asarray(a))["flops"]
    assert got["kernels"] == {} and got["result"].shape == (24, 24)


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _kernel_cases():
    """(kernel, its plain version on small inputs, the tally its wrapper adds)."""
    b, s, h, d = 2, 16, 2, 32
    qkv, g = _rand(b, s, 3 * h * d), _rand(b, s, h * d, seed=1)
    feats = (_rand(b, 8, 2 * h * d, seed=2), _rand(b, 12, 2 * h * d, seed=3))
    q, k, v = _rand(b, h, 10, d), _rand(b, h, 14, d, seed=1), _rand(b, h, 14, d, seed=2)
    out, lse = flash.flash_attention_ref(q, k, v)
    x, w = _rand(1, 64, 6, 5), _rand(64, 64, 3, 3, seed=1)
    a = _rand(2, 3, 4, 16, seed=4)
    return {
        "flash_fused_packed": (lambda: flash.flash_fused_packed_ref(qkv, h, 2),
                               flash._packed_ops(qkv, (), h, 2)),
        "flash_fused_packed_xattn": (lambda: flash.flash_fused_packed_xattn_ref(qkv, feats, h),
                                     flash._packed_ops(qkv, feats, h, 2)),
        "flash_fused_packed_bwd": (lambda: flash.flash_fused_packed_bwd_ref(qkv, g, h, 2),
                                   flash._packed_ops(qkv, (), h, 6)),
        "flash_fused_packed_xattn_bwd": (
            lambda: flash.flash_fused_packed_xattn_bwd_ref(qkv, feats, g, h),
            flash._packed_ops(qkv, feats, h, 6)),
        "flash_nomax_packed": (lambda: flash.flash_nomax_packed_ref(qkv, feats, h),
                               flash._packed_ops(qkv, feats, h, 2)),
        "flash_nomax": (lambda: flash.flash_nomax_ref(q, k, v), flash._bhsd_ops(q, k, 2)),
        "flash_fused": (lambda: flash.flash_fused_ref(q, k, v, norm_eps=1e-4),
                        flash._bhsd_ops(q, k, 2)),
        "flash_attention": (lambda: flash.flash_attention_ref(q, k, v), flash._bhsd_ops(q, k, 2)),
        "flash_attention_bwd": (lambda: flash.flash_attention_bwd_ref(q, k, v, None, out, lse, g[
            :, :10].reshape(b, 10, h, d).transpose(1, 2)), flash._bhsd_ops(q, k, 5)),
        "conv3x3_silu": (lambda: fused_conv_lab.conv3x3_silu_ref(x, w),
                         2 * 1 * 6 * 5 * 9 * 64 * 64),
        "nomax_lab_attention": (lambda: nomax_attn_lab.nomax_attention_ref(q, k, v),
                                flash._bhsd_ops(q, k, 2)),
        # The blocks' elementwise chains: no products.
        "mp_norm_silu": (lambda: mp_fused.norm_silu_ref(a), 0),
        "mp_scale_silu": (lambda: mp_fused.scale_silu_ref(a, a[:, 0, 0]), 0),
        "mp_sum_clip": (lambda: mp_fused.mp_sum_clip_ref(a, a, 0.3, 256.0), 0),
        "mp_cat_silu": (lambda: mp_fused.cat_silu_ref(a, a, 0.5), 0),
    }


@pytest.mark.parametrize("kernel", sorted(flash.launches))
def test_kernel_tallies_count_what_the_plain_versions_count(kernel):
    """Each kernel's wrapper adds to `flash.flops` what FlopCounterMode
    counts for its plain version (K5's norm pre-pass and the blocks'
    elementwise chains: nothing), so a count through the kernels equals one
    through the plain versions. On the CPU the wrappers take the plain
    versions and add nothing themselves."""
    cases = _kernel_cases()
    if kernel == "flash_fused_norm":
        q = _rand(1, 2, 8, 32)
        got = flops_analysis(flash.flash_fused_norm, q, q, q)
        assert got["flops"] == 0 and got["kernels"] == {}
        return
    fn, tally = cases[kernel]
    got = flops_analysis(fn)
    assert got["kernels"] == {} and got["flops"] == tally
    assert tally > 0 or kernel.startswith("mp_")


def _independent_count(net, args, monkeypatch):
    """2 x the multiply-adds of every linear and convolution (from its
    output and weight shapes) and of every attention call (4 B H Sq Sk D,
    from the packed rows the plain versions receive)."""
    import torch.nn.functional as F
    counts = []

    def counting(fn, of):
        def run(*a, **kw):
            out = fn(*a, **kw)
            counts.append(of(out, *a))
            return out
        return run

    product = lambda out, x, w, *_, **__: 2 * out.numel() * w[0].numel()
    monkeypatch.setattr(F, "linear", counting(F.linear, product))
    monkeypatch.setattr(F, "conv2d", counting(F.conv2d, product))
    monkeypatch.setattr(flash, "flash_fused_packed_ref", counting(
        flash.flash_fused_packed_ref, lambda out, qkv, h, *_: flash._packed_ops(qkv, (), h, 2)))
    monkeypatch.setattr(flash, "flash_fused_packed_xattn_ref", counting(
        flash.flash_fused_packed_xattn_ref,
        lambda out, qkv, feats, h, *_: flash._packed_ops(qkv, feats, h, 2)))
    with torch.no_grad():
        net(*args)
    monkeypatch.undo()
    return sum(counts)


@pytest.mark.parametrize("uncond", [False, True])
def test_flops_of_a_precond_forward_equal_an_independent_count(uncond, monkeypatch):
    cfg = PrecondConfig(uncond=uncond, extra_attn=1, **dict(NET, remat=False))
    net = NVPrecond(cfg, seed=0).eval()
    args = (_rand(2, 2, 16, 16, 3), _rand(2, 16, 16, 3, seed=1), torch.ones(2),
            _rand(2, 2, 20, seed=2))
    with torch.no_grad():
        got = flops_analysis(net, *args)
    want = _independent_count(net, args, monkeypatch)
    assert got["flops"] == want > 0


def test_trainer_prints_the_step_count(tmp_path, capsys):
    """The start-up line's count of the first step is that of its loss and
    backward (the optimizer does no products), and counting it changes no
    bit of the step (`test_counting_changes_no_bit`)."""
    from vivid_tpu_torch.diffusion.loss import NVLoss
    data = scenes.make_synthetic_dataset(str(tmp_path / "scenes"), num_scenes=2, num_views=4,
                                         imsize=16)
    loop.training_loop(run_dir=str(tmp_path / "run"), dataset_kwargs={"path": data},
                       network_kwargs=dict(NET, dropout=0.1), batch_size=2, max_steps=1,
                       snapshot_nimg=None, checkpoint_nimg=None, debug=True, device="cpu")
    line = [l for l in capsys.readouterr().out.splitlines() if "Train-step compute" in l]
    net = NVPrecond(PrecondConfig(**dict(NET, dropout=0.1)), seed=0).train()
    args = (_rand(2, 2, 16, 16, 3), _rand(2, 16, 16, 3, seed=1), _rand(2, 2, 20, seed=2))
    real = flops_analysis(lambda: NVLoss()(net, *args, generator=torch.Generator().manual_seed(0))
                          .sum().backward())["flops"]
    assert len(line) == 1 and line[0].split()[2] == f"{real / 1e9:.2f}" and real > 0


def test_counting_changes_no_bit():
    """A step counted by `flops_analysis` ends with the bits of one that was
    not (FlopCounterMode itself runs decompositions that round otherwise)."""
    from vivid_tpu_torch.diffusion.loss import NVLoss
    from vivid_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step
    states = []
    for count in (False, True):
        net = NVPrecond(PrecondConfig(**dict(NET, remat=False)), seed=0).train()
        tcfg = TrainConfig(batch_size=2, nimg_mult=6, rampup_Mimg=0)
        state, step = init_train_state(net, tcfg), make_train_step(NVLoss(), tcfg)
        for i in range(3):
            batch = dict(src=_rand(2, 2, 16, 16, 3, seed=i), tgt=_rand(2, 16, 16, 3, seed=i + 5),
                         geometry=_rand(2, 2, 20, seed=i + 9))
            gen = torch.Generator().manual_seed(i)
            if count and i == 2:
                assert flops_analysis(step, state, batch, gen)["flops"] > 0
            else:
                step(state, batch, gen)
        states.append(state)
    for a, b in zip(states[0].params + states[0].adam_v, states[1].params + states[1].adam_v):
        assert torch.equal(a, b)


# -- --debug-nans ------------------------------------------------------------------

@pytest.fixture(scope="module")
def nan_scenes(tmp_path_factory):
    return scenes.make_synthetic_dataset(str(tmp_path_factory.mktemp("nans")), num_scenes=2,
                                         num_views=4, imsize=16)


PLANTED = "unet.dec.16x16_block0.conv_res0.weight"


def _nan_run(run_dir, data, monkeypatch, **kw):
    """One step of a tiny net with one weight of PLANTED set to NaN."""
    class Planted(NVPrecond):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            with torch.no_grad():
                self.get_parameter(PLANTED)[0, 0, 0, 0] = float("nan")

    monkeypatch.setattr(loop, "NVPrecond", Planted)
    return loop.training_loop(run_dir=str(run_dir), dataset_kwargs={"path": data},
                              network_kwargs=NET, batch_size=2, max_steps=1,
                              snapshot_nimg=None, checkpoint_nimg=None, debug=True,
                              device="cpu", **kw)


def test_debug_nans_names_the_module_of_a_planted_nan(nan_scenes, tmp_path, monkeypatch):
    module = "net." + PLANTED.rsplit(".", 1)[0]
    with pytest.raises(FloatingPointError, match=f"'{module}' \\(MPConv\\)"):
        _nan_run(tmp_path, nan_scenes, monkeypatch, debug_nans=True)
    assert not torch.is_anomaly_enabled()


def test_without_debug_nans_the_step_scrubs_the_nan(nan_scenes, tmp_path, monkeypatch):
    result = _nan_run(tmp_path, nan_scenes, monkeypatch)
    state = result.state
    assert state.adam_step == 1
    assert all(bool(torch.isfinite(p).all()) for n, p in zip(state.names, state.params)
               if n != PLANTED)


def test_debug_nans_passes_finite_outputs_and_removes_its_hooks():
    net = NVPrecond(PrecondConfig(**NET), seed=0)
    args = (_rand(1, 2, 16, 16, 3), _rand(1, 16, 16, 3, seed=1), torch.ones(1),
            _rand(1, 2, 20, seed=2))
    with debug_nans(net=net):
        assert torch.is_anomaly_enabled()
        out = net(*args)
    assert bool(torch.isfinite(out).all()) and not torch.is_anomaly_enabled()
    assert all(not m._forward_hooks for m in net.modules())


# -- the root wrappers, the scripts and the quickstart -----------------------------

WRAPPERS = {"train_nvs_torch": "train_nvs", "generate_images_torch": "generate_images",
            "calculate_metrics_torch": "calculate_metrics",
            "inspect_dataset_torch": "inspect_dataset"}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_root_wrappers_re_export_what_their_twins_do(name):
    sys.path.insert(0, REPO)
    try:
        ours = importlib.import_module(name)
        theirs = importlib.import_module(WRAPPERS[name])
    finally:
        sys.path.remove(REPO)
    public = lambda m: {n for n in vars(m) if not n.startswith("_")
                        and not isinstance(vars(m)[n], type(os))}
    assert public(ours) == public(theirs) - {"click", "np", "PIL"}
    for n in public(ours) - {"cmdline", "main"}:
        assert getattr(ours, n).__module__.startswith("vivid_tpu_torch."), n
    entry = getattr(ours, "cmdline", None) or ours.main
    result = CliRunner().invoke(entry, ["--help"])
    assert result.exit_code == 0 and "--help" in result.output


def test_torch_scripts_name_the_port():
    scripts = tomllib.load(open(os.path.join(REPO, "pyproject.toml"), "rb"))["project"]["scripts"]
    for kind in ("train", "generate", "metrics", "inspect"):
        module, attr = scripts[f"vivid-torch-{kind}"].split(":")
        assert module.startswith("vivid_tpu_torch.cli.")
        assert callable(getattr(importlib.import_module(module), attr))
        jmodule = scripts.get(f"vivid-{kind}", "vivid_tpu.cli.inspect_dataset:").split(":")[0]
        assert module == "vivid_tpu_torch" + jmodule[len("vivid_tpu"):]


def test_quickstart_runs_on_the_cpu(tmp_path):
    """16 px, ch 16, 2 steps: the 0.050 snapshot, 8 PNGs, and the metric keys
    that vivid_tpu's `get_metrics` gives for the same list."""
    from vivid_tpu.metrics.api import get_metrics as jget_metrics
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(REPO, "examples", "quickstart_torch.py"))
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    out = quickstart.main(["--workdir", str(tmp_path), "--steps", "2", "--channels", "16",
                           "--resolution", "16", "--device", "cpu"])
    assert out["snapshot"].endswith("-0.050.pkl") and os.path.isfile(out["snapshot"])
    assert len([f for f in os.listdir(out["samples"]) if f.startswith("sample_")]) == 8
    want = jget_metrics(net=out["snapshot"], num_images=2, max_batch_size=2,
                        metrics=["stub_fid", "psnr"],
                        datakwargs={"path": str(tmp_path / "scenes")}, num_steps=2)
    assert sorted(out["metrics"]) == sorted(want)
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert out["workdir"] == str(tmp_path)


def test_quickstart_workdir_is_fresh_or_empty(tmp_path, monkeypatch):
    """Without --workdir the quickstart takes a new directory under $TMPDIR
    (two runs never share one); a non-empty --workdir is refused before any
    work, so no run reads an earlier run's snapshots."""
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(REPO, "examples", "quickstart_torch.py"))
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)   # re-read $TMPDIR
    first, second = quickstart.make_workdir(), quickstart.make_workdir()
    assert first != second and os.path.dirname(first) == str(tmp_path)
    assert os.listdir(first) == [] and os.listdir(second) == []
    new = str(tmp_path / "new" / "qs")
    assert quickstart.make_workdir(new) == new and os.path.isdir(new)
    (tmp_path / "used").mkdir()
    (tmp_path / "used" / "run").mkdir()
    with pytest.raises(SystemExit, match="not empty"):
        quickstart.main(["--workdir", str(tmp_path / "used"), "--device", "cpu"])
