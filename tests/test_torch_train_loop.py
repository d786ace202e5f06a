"""The port's trainer entry point end to end on the CPU at tiny width:
`training_loop` on synthetic scenes, its log and snapshots, sampling from a
snapshot it wrote, bitwise repeatability from a seed, and the CLI."""

import json
import os

import numpy as np
import pytest
import torch

from vivid_tpu.data import collate as jcollate
from vivid_tpu_torch.cli import train_nvs
from vivid_tpu_torch.data import collate, scenes
from vivid_tpu_torch.generate import generate_images_nvs
from vivid_tpu_torch.train.loop import training_loop
from vivid_tpu_torch.train.snapshots import load_snapshot

torch.set_num_threads(1)

NET = dict(img_resolution=16, model_channels=16, channel_mult=(1, 2), num_blocks=1,
           attn_resolutions=(8,), channels_per_head=8, use_bf16=False, remat=False)
STEPS = 3
NIMG_PER_STEP = 2 * 6        # batch 2, nimg_mult 6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return scenes.make_synthetic_dataset(str(tmp_path_factory.mktemp("loop") / "scenes"),
                                         num_scenes=3, num_views=4, imsize=16)


def _train(run_dir, data, **kw):
    args = dict(run_dir=str(run_dir), dataset_kwargs={"path": data}, network_kwargs=NET,
                loss_kwargs=dict(P_mean=-0.8, P_std=1.6),
                lr_kwargs=dict(ref_lr=0.01, rampup_Mimg=0.0), seed=3, batch_size=2,
                status_nimg=NIMG_PER_STEP, snapshot_nimg=STEPS * NIMG_PER_STEP,
                max_steps=STEPS, device="cpu")
    args.update(kw)
    return training_loop(**args)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, data):
    run_dir = tmp_path_factory.mktemp("run_a")
    return run_dir, _train(run_dir, data)


def test_training_loop_logs_every_status_line(trained, capsys):
    run_dir, result = trained
    lines = open(run_dir / "log.txt").read().splitlines()
    status = [l for l in lines if l.startswith("Status:")]
    assert len(status) == len(result.ticks) == STEPS + 1      # the tick at nimg 0 too
    assert [t["nimg"] for t in result.ticks] == [i * NIMG_PER_STEP for i in range(STEPS + 1)]
    assert [t["steps"] for t in result.ticks] == [0] + [1] * STEPS
    for t in result.ticks[1:]:
        assert np.isfinite(t["loss"]) and np.isfinite(t["grad_norm"]) and t["grad_norm"] > 0
        assert t["learning_rate"] == pytest.approx(0.01)
    assert any("nimg_mult 6" in l for l in lines)
    assert result.state.cur_nimg == STEPS * NIMG_PER_STEP and result.state.adam_step == STEPS


def test_training_loop_writes_a_snapshot_per_ema_std_that_samples(trained, data, tmp_path):
    run_dir, result = trained
    names = sorted(f for f in os.listdir(run_dir) if f.endswith(".pkl"))
    assert names == ["network-snapshot-0000000-0.050.pkl", "network-snapshot-0000000-0.100.pkl"]
    snap = load_snapshot(str(run_dir / names[0]))
    assert snap.cfg.img_resolution == 16 and snap.loss_kwargs == dict(P_mean=-0.8, P_std=1.6)
    ema = result.state.ema_state_dict(0)
    for name, t in snap.net.state_dict().items():      # stored fp16
        torch.testing.assert_close(t, ema[name].half().float(), rtol=0, atol=0)
    assert not torch.equal(result.state.emas[0][0], result.state.emas[1][0])
    batches = list(generate_images_nvs(net=snap, outdir=str(tmp_path / "out"), seeds=[0, 1],
                                       max_batch_size=2, datakwargs={"path": data},
                                       num_steps=2, verbose=False, device="cpu"))
    assert batches[0].images.shape == (2, 16, 16, 3)
    assert bool(torch.isfinite(batches[0].latents).all())
    assert len(os.listdir(tmp_path / "out")) == 6


def test_same_seed_gives_bitwise_equal_snapshots(trained, data, tmp_path):
    run_dir, _ = trained
    _train(tmp_path, data)
    for name in ("network-snapshot-0000000-0.050.pkl", "network-snapshot-0000000-0.100.pkl"):
        assert open(run_dir / name, "rb").read() == open(tmp_path / name, "rb").read(), name
    other = tmp_path / "other"
    _train(other, data, seed=4)
    assert open(run_dir / name, "rb").read() != open(other / name, "rb").read()


def test_training_loop_accumulates_and_refuses_what_is_not_ported(data, tmp_path):
    result = _train(tmp_path / "acc", data, batch_size=4, batch_gpu=2, max_steps=1,
                    status_nimg=24, snapshot_nimg=None)
    assert result.state.cur_nimg == 24 and result.ticks[-1]["steps"] == 1
    assert "in 2 microbatch(es)" in open(tmp_path / "acc" / "log.txt").read()
    with pytest.raises(ValueError, match="not divisible"):
        _train(tmp_path / "bad", data, batch_size=4, batch_gpu=3)
    # The depth flags were refused until depth conditioning was ported: each
    # now trains a step with a depth model, and refuses to run without one.
    depth_model = lambda x: 1.0 + x.mean(-1) ** 2   # noqa: E731
    for flag in ("depth_input", "warp_depth_coor"):
        net = dict(NET, **{flag: True})
        result = _train(tmp_path / flag, data, network_kwargs=net, depth_model=depth_model,
                        max_steps=1, snapshot_nimg=None)
        assert result.state.cur_nimg == NIMG_PER_STEP
        with pytest.raises(ValueError, match="needs a depth_model"):
            _train(tmp_path / f"{flag}_none", data, network_kwargs=net)


def test_cli_dry_run_prints_the_config(capsys):
    out = train_nvs.cmdline(["--data", "scenes/", "--preset", "vivid-uncond", "--dry-run",
                             "--batch", "8", "--duration", "1Ki", "--remat", "save_dots"],
                            standalone_mode=False)
    assert out is None
    text = capsys.readouterr().out
    cfg = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert cfg["batch_size"] == 8 and cfg["total_nimg"] == 1024
    assert cfg["network_kwargs"] == dict(
        model_channels=128, dropout=0.0, extra_attn=1, epipolar_attention_bias=False,
        super_res=False, no_time_enc=False, depth_input=False, warp_depth_coor=False,
        uncond=True, noisy_sr=0.25, num_sources=2,
        source_label_dim=20, target_label_dim=40, use_bf16=True, force_wn=False,
        remat="save_dots")
    assert not cfg["sr_training"] and not cfg["vanilla_mode"]
    assert cfg["loss_kwargs"] == dict(P_mean=-0.8, P_std=1.6)
    assert cfg["lr_kwargs"] == dict(ref_lr=0.012, ref_batches=35000)
    assert "Dry run" in text


def test_cli_presets_match_the_jax_package():
    from vivid_tpu.cli import train_nvs as jcli
    for name, preset in train_nvs.config_presets.items():
        assert dict(preset) == dict(jcli.config_presets[name]), name
    for text, want in (("960", 960), ("2Ki", 2048), ("3Mi", 3 << 20), ("1Gi", 1 << 30)):
        assert train_nvs.parse_nimg(text) == jcli.parse_nimg(text) == want


@pytest.mark.parametrize("flags", [["--fsdp"], ["--depth-input"], ["--metrics", "1Ki"],
                                   ["--depth-model", "small"], ["--warp-depth-coor"]])
def test_cli_unported_options_raise(flags, capsys):
    """Each flag of a feature not ported raises. `--metrics`, the depth
    flags and `--fsdp` were such until their features were ported: their
    cases now check that the dry run takes them."""
    taken = {"--metrics": '"metrics_nimg": 1024', "--depth-input": '"depth_input": true',
             "--fsdp": '"fsdp": true',
             "--depth-model": '"depth_model": "small"',
             "--warp-depth-coor": '"warp_depth_coor": true'}
    if flags[0] in taken:
        train_nvs.cmdline(["--data", "scenes/", "--dry-run", *flags], standalone_mode=False)
        assert taken[flags[0]] in capsys.readouterr().out
        return
    with pytest.raises(NotImplementedError):
        train_nvs.cmdline(["--data", "scenes/", "--dry-run", *flags], standalone_mode=False)


@pytest.mark.parametrize("flags,sr,sources,batch", [
    (["--sr-training"], True, 2, 1024),
    (["--vanilla-mode"], False, 1, 1024),
    (["--preset", "vivid-sr"], True, 1, 128),
])
def test_cli_sr_and_vanilla_options_build_their_configs(flags, sr, sources, batch, capsys):
    """The flags that used to be refused, against the JAX package's CLI."""
    from vivid_tpu.cli import train_nvs as jcli
    train_nvs.cmdline(["--data", "scenes/", "--dry-run", *flags], standalone_mode=False)
    text = capsys.readouterr().out
    cfg = json.loads(text[text.index("{"):text.rindex("}") + 1])
    preset = flags[1] if flags[0] == "--preset" else "vivid-base"
    want = jcli.setup_training_config(preset=preset, data="scenes/",
                                      sr_training="--sr-training" in flags,
                                      vanilla_mode="--vanilla-mode" in flags)
    net = cfg["network_kwargs"]
    assert (cfg["sr_training"], cfg["vanilla_mode"], cfg["batch_size"]) == (
        sr, sources == 1, batch) == (want.sr_training, want.vanilla_mode, want.batch_size)
    assert (net["super_res"], net["num_sources"], net["target_label_dim"]) == (
        sr, sources, 20 * sources)
    for key, value in net.items():
        assert value == want.network_kwargs[key], key


def test_cli_trains(data, tmp_path):
    result = train_nvs.cmdline(
        ["--data", data, "--outdir", str(tmp_path), "--device", "cpu", "--channels", "16",
         "--batch", "2", "--bf16", "false", "--status", "12", "--snapshot", "12",
         "--max-steps", "1", "--remat", "true"], standalone_mode=False)
    run_dir = tmp_path / "experiments"
    assert result.state.adam_step == 1
    assert json.load(open(run_dir / "training_options.json"))["max_steps"] == 1
    assert sum(f.endswith(".pkl") for f in os.listdir(run_dir)) == 2


def test_collate_nimg_mult_and_skip_rows(data):
    """nimg_mult as the JAX trainer reads it, and a loader that skips rows
    continues the stream where a loader that consumed them stands."""
    assert collate.DualSourceCollate.nimg_mult == jcollate.DualSourceCollate.nimg_mult == 6

    def loader(skip):
        return collate.BatchLoader(iter(scenes.SceneDataset(data, seed=1)),
                                   collate.DualSourceCollate(imsize=16, seed=2),
                                   batch_size=2, skip_rows=skip)
    full, resumed = loader(0), loader(4)
    try:
        next(full), next(full)
        a, b = next(full), next(resumed)
    finally:
        full.close()
        resumed.close()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
