"""The port's trainer shell on the CPU at tiny width: the logger, the
process helpers, the stats collector, the parameter table and the registry
against the JAX package's; checkpoints; single-image rows bitwise equal to
the JAX package's; the loop's schedule (files, "Training from" lines and
stats.jsonl keys) against the JAX loop's under the same arguments; and the
port alone: deterministic kill-and-resume is bitwise, a suspend saves where
it stops, a resumed run writes no snapshot again where it resumed, and the
CLI hands its new flags to the loop."""

import json
import os
import sys

import numpy as np
import PIL.Image
import pytest
import torch

from vivid_tpu.core import dist as jdist, stats as jstats
from vivid_tpu_torch.cli import train_nvs
from vivid_tpu_torch.core import checkpoint, dist, logger, registry, stats, summary
from vivid_tpu_torch.data import scenes, single_images
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train import loop as loop_mod
from vivid_tpu_torch.train.loop import training_loop
from vivid_tpu_torch.train.step import TrainConfig, init_train_state

torch.set_num_threads(1)

TINY = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,),
            channels_per_head=8, use_bf16=False)
NET = dict(TINY, img_resolution=16, remat=False)
BATCH = 8
NIMG_STEP = BATCH * 6       # dual-source: nimg_mult 6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return scenes.make_synthetic_dataset(str(tmp_path_factory.mktemp("shell") / "scenes"),
                                         num_scenes=4, num_views=6, imsize=16)


@pytest.fixture(scope="module")
def singles(tmp_path_factory):
    """Single images whose centre crops are whole multiples of 16 and 32."""
    path = tmp_path_factory.mktemp("singles")
    rs = np.random.RandomState(0)
    for i, shape in enumerate([(64, 96, 3), (96, 64, 3), (32, 48, 3)]):
        PIL.Image.fromarray(rs.randint(0, 255, shape, np.uint8)).save(path / f"im{i}.png")
    return str(path)


def _train(run_dir, data, **kw):
    args = dict(run_dir=str(run_dir), dataset_kwargs={"path": data}, network_kwargs=NET,
                loss_kwargs=dict(P_mean=-0.8, P_std=1.6),
                lr_kwargs=dict(ref_lr=1e-3, ref_batches=100, rampup_Mimg=0), seed=0,
                batch_size=BATCH, total_nimg=4 * NIMG_STEP, status_nimg=None,
                samples_nimg=None, snapshot_nimg=None, checkpoint_nimg=2 * NIMG_STEP,
                device="cpu")
    args.update(kw)
    return training_loop(**args)


# -- core modules --------------------------------------------------------------------

def test_logger_keeps_stderr_on_stderr(tmp_path, capsys):
    with logger.Logger(str(tmp_path / "log.txt"), "a"):
        print("to stdout")
        print("to stderr", file=sys.stderr)
    captured = capsys.readouterr()
    assert captured.out == "to stdout\n" and captured.err == "to stderr\n"
    assert open(tmp_path / "log.txt").read() == "to stdout\nto stderr\n"
    assert sys.stdout is not None and not isinstance(sys.stdout, logger._Tee)
    assert logger.format_time(3725) == "1h 02m 05s" == __import__(
        "vivid_tpu.core.logger", fromlist=["x"]).format_time(3725)


def test_dist_on_one_process_and_the_suspend_flag():
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
    dist.request_suspend()
    assert dist.should_suspend() and not dist.should_stop()
    dist.init()   # a new run starts with no suspend pending
    assert not dist.should_suspend()
    dist.barrier()


def test_sigterm_suspends_and_reaches_the_handler_before():
    """SIGTERM asks the trainer to suspend, and still reaches a Python
    handler installed before `init()` (another library's, the JAX
    package's), whichever of the two was installed first."""
    import signal
    seen = []
    old = signal.signal(signal.SIGTERM, lambda signum, frame: seen.append(signum))
    try:
        dist.init()
        dist.init()   # again: the handler before is still the one chained
        os.kill(os.getpid(), signal.SIGTERM)
        assert dist.should_suspend() and seen == [signal.SIGTERM]
    finally:
        dist.init()   # no suspend left pending
        signal.signal(signal.SIGTERM, old)


def test_collector_matches_jax():
    rng = np.random.RandomState(0)
    reports = [("Loss/loss", rng.randn(5)), ("Loss/loss", np.array([np.nan, 2.0])),
               ("Grad/norm", np.float32(3.5)), ("Loss/loss", torch.tensor([1.0, np.inf])),
               ("Timing/sec", 0.25)]
    ours, theirs = stats.Stats(), jstats.Stats()
    for name, v in reports:
        ours.report(name, v)
        theirs.report(name, v.numpy() if torch.is_tensor(v) else v)
    a, b = stats.Collector(ours, "Loss/.*|Grad/.*"), jstats.Collector(theirs, "Loss/.*|Grad/.*")
    a.update(), b.update()
    got, want = a.as_dict(), b.as_dict()
    assert got == want and set(got) == {"Loss/loss", "Grad/norm"}
    assert got["Loss/loss"].num == 7 and "Timing/sec" in ours._pending


def test_param_table_matches_jax():
    import jax
    from vivid_tpu.core.summary import param_table as jtable
    from vivid_tpu.nn.precond import PrecondConfig as JConfig, precond_init
    jparams = jax.eval_shape(lambda: precond_init(jax.random.PRNGKey(0),
                                                  JConfig(img_resolution=16, **TINY)))
    net = NVPrecond(PrecondConfig(img_resolution=16, **TINY), seed=0)
    assert summary.param_table(net.state_dict()) == jtable(jparams)
    assert summary.count_params(net.state_dict()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))


def test_registry_resolves_reference_and_jax_names_to_the_port():
    from vivid_tpu_torch.data.encoders import StandardRGBEncoder
    for name in ("vivid_tpu.data.encoders.StandardRGBEncoder",
                 "training.encoders.StandardRGBEncoder",
                 "vivid_tpu_torch.data.encoders.StandardRGBEncoder"):
        assert isinstance(registry.construct_class_by_name(class_name=name), StandardRGBEncoder)
    with pytest.raises(ImportError):
        registry.get_obj_by_name("vivid_tpu_torch.no_such_module.Thing")


def test_checkpoint_round_trip_torn_files_and_latest(tmp_path):
    cfg = TrainConfig(batch_size=2)
    state = init_train_state(NVPrecond(PrecondConfig(img_resolution=16, **TINY), seed=0), cfg)
    with torch.no_grad():
        for i, t in enumerate(state.adam_v):
            t.fill_(i + 0.5)
    state.adam_step, state.cur_nimg = 3, 36
    io = checkpoint.CheckpointIO(state=state)
    path = str(tmp_path / "training-state-0000010.pt")
    io.save(path, async_=True)
    with torch.no_grad():          # the state moves on; the file holds it as it was
        state.adam_v[0].fill_(-1.0)
    io.wait()
    assert io.copy_seconds >= 0 and io.write_seconds >= 0
    other = init_train_state(NVPrecond(PrecondConfig(img_resolution=16, **TINY), seed=1), cfg)
    checkpoint.CheckpointIO(state=other).load(path)
    assert (other.adam_step, other.cur_nimg) == (3, 36)
    assert float(other.adam_v[0].flatten()[0]) == 0.5
    for a, b in zip(other.params + other.emas[1], state.params + state.emas[1]):
        assert torch.equal(a, b)
    for name in ("training-state-0000002.pt", "training-state-0000011.pt.tmp",
                 "training-state-x.pt"):
        open(tmp_path / name, "wb").close()
    assert checkpoint.latest_checkpoint(str(tmp_path)) == path
    assert not os.path.exists(tmp_path / "training-state-0000011.pt.tmp")
    assert checkpoint.latest_checkpoint(str(tmp_path / "missing")) is None


def test_single_image_rows_are_bitwise_the_jax_packages(singles):
    import jax
    from vivid_tpu.data.single_images import SingleImages as JSingleImages
    key = jax.random.PRNGKey(7)
    for data in (0, 5, 123456):
        jk, pk = jax.random.fold_in(key, data), single_images.fold_in(
            single_images.prng_key(7), data)
        np.testing.assert_array_equal(np.asarray(jk), pk)
        for a, b in zip(jax.random.split(jk, 3), single_images.split(pk, 3)):
            np.testing.assert_array_equal(np.asarray(a), b)
            assert np.asarray(jax.random.uniform(a, (), minval=-1, maxval=1)) == \
                single_images.uniform(b)
    for imsize, sources in ((16, 2), (32, 1)):
        ours = single_images.SingleImages(singles, imsize=imsize, num_sources=sources, seed=3)
        theirs = JSingleImages(singles, imsize=imsize, num_sources=sources, seed=3)
        for _ in range(6):
            plan = ours.sample_plan()
            assert plan == theirs.sample_plan()
            got, want = ours.materialize(None, plan)[0], theirs.materialize(None, plan)[0]
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the loop against the JAX loop -----------------------------------------------------

def _files(run_dir):
    names = [f for f in os.listdir(run_dir)
             if f.startswith(("training-state-", "network-snapshot-"))]
    return sorted(names) + sorted("results/" + f for f in os.listdir(os.path.join(run_dir,
                                                                                  "results")))


def _stats_keys(run_dir):
    rows = [json.loads(l) for l in open(os.path.join(run_dir, "stats.jsonl"))]
    return [sorted(k for k in r if not k.startswith(("Resources/peak_", "Resources/hbm")))
            for r in rows]


def test_loop_schedule_matches_jax(data, tmp_path, capsys):
    """4 steps, checkpoints and snapshots every 2, sample grids every 2, run
    as a slice of 2 steps and a resume, in both packages."""
    from vivid_tpu.train.loop import training_loop as jtraining_loop
    common = dict(dataset_kwargs={"path": data}, test_dataset_path=data, eval_samples=2,
                  loss_kwargs=dict(P_mean=-0.8, P_std=1.6),
                  lr_kwargs=dict(ref_lr=1e-3, ref_batches=100, rampup_Mimg=0),
                  batch_size=BATCH, total_nimg=4 * NIMG_STEP, status_nimg=NIMG_STEP,
                  samples_nimg=2 * NIMG_STEP, snapshot_nimg=2 * NIMG_STEP,
                  checkpoint_nimg=2 * NIMG_STEP, slice_nimg=2 * NIMG_STEP, deterministic=True)
    lines = {}
    micro = dict(TINY, img_resolution=16, channel_mult=(1,), attn_resolutions=(16,))
    for name, fn, device in (("jax", jtraining_loop, {}), ("port", training_loop,
                                                           dict(device="cpu"))):
        run_dir = str(tmp_path / name)
        kw = dict(common, run_dir=run_dir, network_kwargs=micro, **device)
        try:
            for _ in range(2):
                fn(**kw)
                jdist._should_suspend = False   # the slice's suspend request, in the JAX package
        finally:
            jdist._should_suspend = False
        lines[name] = [l for l in capsys.readouterr().out.splitlines()
                       if l.startswith("Training from")]
    assert lines["port"] == lines["jax"] == ["Training from 0 kimg to 0 kimg (2 steps):"] * 2
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "network-snapshot-0000000-0.050.pkl", "network-snapshot-0000000-0.100.pkl",
        "training-state-0000000.pt", "results/generated-samples-0000000.png"]
    assert _stats_keys(tmp_path / "port") == _stats_keys(tmp_path / "jax")
    grid = np.asarray(PIL.Image.open(tmp_path / "port" / "results" /
                                     "generated-samples-0000000.png"))
    assert grid.shape == (3 * 16, 2 * 16, 3)


# -- the port alone ----------------------------------------------------------------------

@pytest.mark.parametrize("mix", [None, 0.25])
def test_deterministic_kill_and_resume_is_bitwise(data, singles, tmp_path, mix):
    kw = dict(deterministic=True, single_image_mix=mix, single_image_mix_path=singles)
    straight = _train(tmp_path / "a", data, **kw).state
    _train(tmp_path / "b", data, max_steps=2, **kw)        # "killed" after its checkpoint at 96
    resumed = _train(tmp_path / "b", data, **kw).state
    assert straight.cur_nimg == resumed.cur_nimg == 4 * NIMG_STEP
    assert straight.adam_step == resumed.adam_step == 4
    for group in ("params", "adam_m", "adam_v"):
        for a, b in zip(getattr(straight, group), getattr(resumed, group)):
            assert torch.equal(a, b), group
    for ea, eb in zip(straight.emas, resumed.emas):
        assert all(torch.equal(a, b) for a, b in zip(ea, eb))
    assert "Resuming from" in open(tmp_path / "b" / "log.txt").read()


def test_suspend_saves_a_checkpoint_where_it_stops(data, tmp_path, monkeypatch):
    calls = []

    def suspend_at_third_tick():
        calls.append(1)
        return len(calls) > 2

    monkeypatch.setattr(dist, "should_suspend", suspend_at_third_tick)
    result = _train(tmp_path, data, total_nimg=10_000_000, status_nimg=NIMG_STEP,
                    checkpoint_nimg=1_000_000, max_steps=10, progress_bar=True,
                    encoder_kwargs=dict(class_name="training.encoders.StandardRGBEncoder"))
    assert result.state.cur_nimg == 2 * NIMG_STEP
    files = [f for f in os.listdir(tmp_path) if f.startswith("training-state-")]
    assert files == ["training-state-0000000.pt"]
    saved = checkpoint.load_checkpoint(str(tmp_path / files[0]))["state"]
    assert saved["cur_nimg"] == 96 and saved["adam_step"] == 2
    log = open(tmp_path / "log.txt").read()
    assert "Suspending at 96 nimg with a checkpoint" in log
    assert "train:" in log and "loss=" in log         # the progress bar, asked for here


def test_resume_writes_no_snapshot_again_where_it_resumed(data, tmp_path, monkeypatch):
    saved = []
    real = loop_mod.save_snapshot
    monkeypatch.setattr(loop_mod, "save_snapshot",
                        lambda fname, *a, **kw: (saved.append(fname), real(fname, *a, **kw)))
    _train(tmp_path, data, snapshot_nimg=2 * NIMG_STEP, slice_nimg=2 * NIMG_STEP)
    assert len(saved) == 2                      # one per EMA std at 96
    _train(tmp_path, data, snapshot_nimg=2 * NIMG_STEP, slice_nimg=2 * NIMG_STEP)
    assert len(saved) == 4                      # ... and at 192, none again at 96


def test_deterministic_on_cuda_needs_the_cublas_workspace(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        with loop_mod.deterministic_algorithms(True):
            pass
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    with loop_mod.deterministic_algorithms(True):
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert torch.are_deterministic_algorithms_enabled() == before


def test_cli_hands_the_new_flags_to_the_loop(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(loop_mod, "training_loop", lambda **kw: seen.update(kw))
    train_nvs.cmdline(["--data", "scenes/", "--outdir", str(tmp_path), "--slice", "2Ki",
                       "--deterministic", "--test-data-path", "test/", "--sr-model", "sr.pkl",
                       "--single-image-mix", "0.25", "--single-image-path", "imgs/"],
                      standalone_mode=False)
    assert (seen["slice_nimg"], seen["deterministic"], seen["test_dataset_path"],
            seen["sr_model"], seen["single_image_mix"], seen["single_image_mix_path"]) == (
        2048, True, "test/", "sr.pkl", 0.25, "imgs/")
    code = tmp_path / "experiments" / "code"      # the run's provenance, as the JAX CLI keeps it
    assert json.load(open(code / "provenance.json"))["torch_version"] == torch.__version__
    assert os.path.getsize(code / "source.tar.gz") > 0
    # The JAX CLI's defaults for the checkpoint and sample intervals.
    assert (seen["checkpoint_nimg"], seen["samples_nimg"]) == (10000, 9600)
    from vivid_tpu.cli import train_nvs as jcli
    want = jcli.setup_training_config(data="scenes/", slice=2048, deterministic=True,
                                      test_data_path="test/", sr_model="sr.pkl",
                                      single_image_mix=0.25, single_image_path="imgs/",
                                      checkpoint=10000, samples=9600)
    for key in ("slice_nimg", "deterministic", "test_dataset_path", "sr_model",
                "single_image_mix", "single_image_mix_path", "checkpoint_nimg",
                "samples_nimg"):
        assert seen[key] == want[key], key


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Single images at RealEstate10K's 640 x 360 frame size and its
    portrait: their 360 px crops resize to 64 and 256 by no whole factor."""
    path = tmp_path_factory.mktemp("frames")
    rs = np.random.RandomState(1)
    for i, shape in enumerate([(360, 640, 3), (640, 360, 3)]):
        PIL.Image.fromarray(rs.randint(0, 255, shape, np.uint8)).save(path / f"im{i}.png")
    return str(path)


def test_single_image_rows_match_jax_at_non_whole_sizes(frames):
    """ROADMAP C10: at a 360 px crop to 64 px, with the SR fields at 256,
    the rows are still the JAX package's bit for bit (the native resize)."""
    from vivid_tpu.data.single_images import SingleImages as JSingleImages
    ours = single_images.SingleImages(frames, imsize=64, sr_size=256, num_sources=2, seed=5)
    theirs = JSingleImages(frames, imsize=64, sr_size=256, num_sources=2, seed=5)
    for _ in range(3):
        plan = ours.sample_plan()
        assert plan == theirs.sample_plan()
        got, want = ours.materialize(None, plan)[0], theirs.materialize(None, plan)[0]
        assert sorted(got) == sorted(want) and got["sr_src_image"].shape == (2, 256, 256, 3)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("flags", [["--metrics", "1Ki"], ["--fsdp"], ["--depth-input"],
                                   ["--depth-model", "small"], ["--warp-depth-coor"]])
def test_cli_flags_still_not_ported_raise(flags, capsys):
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
