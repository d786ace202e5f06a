"""The port over two processes on the CPU (gloo), against the JAX package.

Each test starts its ranks with `torch_dist_worker.run_ranks` (a FileStore
under tmp_path, a time limit a job, JAX never imported in a rank) and holds
what they return to the JAX package's global-batch step, loader rows and
seed split in this process:

  * the data-parallel step (two ranks of 2 rows) against JAX's step at the
    global batch of 4, with one row planted as an outlier: the clamp's
    statistics are the global batch's, and a per-rank clamp misses the
    gradient tolerance; then the consistency check, which passes on the
    replicas and names the tree when one rank's weight moves by one ulp;
  * the same under FSDP, started from a checkpoint written without it,
    whose own checkpoint has the layout without FSDP and loads without it;
  * the trainer at two ranks: each rank's rows are the JAX loader's for its
    process_index, rank 0 alone writes, a resume continues, and the stats
    count both ranks; with single_image_mix rank 0 draws the JAX package's
    single-image rows and rank 1 rows of its own;
  * the seed split of `generate_images_nvs`, rank by rank, against the JAX
    package's with its rank and world size patched;
  * `calculate_metrics gen`'s statistics over two ranks against one, the
    two host reductions under gloo (named by the caller for a card's
    device) and a suspend that reaches every rank;
  * `dist.init`: no group for one process, no fallback to gloo when NCCL
    cannot start, and a step that refuses unequal shares before any
    collective;
  * the entry points' default device: this rank's card, cuda:LOCAL_RANK.

Tolerances are those of tests/test_torch_train_step.py (fp32 on both sides,
sums in another order).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.data import collate as jcollate
from vivid_tpu.data.re10k_scenes import open_scene_dataset as jopen_scene_dataset
from vivid_tpu.diffusion import loss as jloss
from vivid_tpu.train import step as jstep
from vivid_tpu_torch.compat.from_jax import train_state_from_jax, train_state_to_jax
from vivid_tpu_torch.core import checkpoint, dist
from vivid_tpu_torch.data import scenes
from vivid_tpu_torch.train import step

from test_torch_train_step import (GRAD_REL_L2, MICRO, _draws, _flat, _hold_stepped,
                                   _numpy_state, _rel_l2, _setup, _wrapped)
from torch_dist_worker import (metrics_job, run_ranks, single_rows_job, step_job,
                               trainer_job)

torch.set_num_threads(1)

B = 4            # the global batch: two ranks of 2 rows
STEPS = 2
OUTLIER = 30.0   # one target row scaled by this: its loss drags the global statistics


@pytest.fixture(scope="module")
def ref():
    """JAX's two steps (force_wn on, which needs whole rows on each rank
    under FSDP) and its step-1 gradient at the global batch, one row an
    outlier; the draws each rank gets half of."""
    env = _setup(uncond=False, res=8, tiny=MICRO, force_wn=True)
    env.jcfgt = dataclasses.replace(env.jcfgt, batch_size=B)
    env.tcfgt = dataclasses.replace(env.tcfgt, batch_size=B)
    jfn = _wrapped(env.jfn)
    jstep_fn = jstep.make_train_step(jfn, env.jcfg, env.jcfgt, env.exps)

    def scalar(params, rng, batch):
        l = jloss.clamp_loss(jfn(params, env.jcfg, rng, batch["src"], batch["tgt"],
                                 batch["geometry"], train=True))
        return jnp.sum(l) / B

    both = jax.jit(lambda s, b, k: (jax.grad(scalar)(s.params, k, b), jstep_fn(s, b, k)))
    rng = np.random.RandomState(11)
    batches = [dict(src=rng.randn(B, 2, 8, 8, 3).astype(np.float32),
                    tgt=rng.randn(B, 8, 8, 3).astype(np.float32),
                    geometry=rng.randn(B, 2, 20).astype(np.float32)) for _ in range(STEPS)]
    for b in batches:
        b["tgt"][3] *= OUTLIER   # on rank 1
    keys = [jax.random.PRNGKey(40 + i) for i in range(STEPS)]
    start = _numpy_state(env.state)
    jstate, grads, stats = env.state, None, []
    for b, k in zip(batches, keys):
        g, (jstate, st) = both(jstate, b, k)
        grads = grads if grads is not None else _flat(jax.tree.map(np.asarray, g))
        stats.append({n: float(v) for n, v in st.items()})
    draws = [tuple(t.numpy() for t in _draws(env.jfn, k, (B, 8, 8, 3))) for k in keys]
    return dict(env=env, start=start, end=_numpy_state(jstate), grads=grads, stats=stats,
                batches=batches, draws=draws,
                job=dict(cfg=dataclasses.asdict(env.tcfg),
                         train_cfg=dataclasses.asdict(env.tcfgt),
                         params=start["params"], batches=batches, draws=draws))


def _hold_state(got, ref):
    """The port's state after the steps against JAX's, as
    test_torch_train_step.py holds them."""
    assert int(got["cur_nimg"]) == int(ref["end"]["cur_nimg"]) == STEPS * B * 6
    before = _flat(ref["start"]["params"])
    _hold_stepped(_flat(got["params"]), _flat(ref["end"]["params"]), before, STEPS, "params")
    for i in range(2):
        _hold_stepped(_flat(got["emas"][i]), _flat(ref["end"]["emas"][i]), before, STEPS,
                      f"ema {i}")
    for key, tol in (("adam_m", 1e-3), ("adam_v", 2e-3)):
        want, have = _flat(ref["end"][key]), _flat(got[key])
        bad = {n: _rel_l2(have[n], w) for n, w in want.items()
               if np.linalg.norm(w) > 0 and _rel_l2(have[n], w) > tol}
        assert not bad, (key, bad)


def _grad_errors(got, want):
    return {n: _rel_l2(g, want[n]) for n, g in got.items() if np.linalg.norm(want[n]) > 0}


def test_data_parallel_step_matches_the_global_batch_and_checks_consistency(ref, tmp_path):
    ranks = run_ranks(step_job, 2, tmp_path, consistency=True, **ref["job"])
    got = ranks[0]
    bad = {n: e for n, e in _grad_errors(got["grads"], ref["grads"]).items()
           if e > GRAD_REL_L2}
    assert not bad, bad
    for js, ts in zip(ref["stats"], got["stats"]):   # the global loss and its std
        for k in js:
            assert ts[k] == pytest.approx(js[k], rel=1e-4), k
    _hold_state(got["state"], ref)
    # Both ranks hold the same replicas; one ulp on one rank is caught, by name.
    assert all(r["equal_passes"] for r in ranks)
    assert ranks[0]["fingerprint"] != ranks[1]["fingerprint"]
    for r in ranks:
        assert r["nudged"] is not None and "'net params'" in r["nudged"]
        assert ranks[0]["fingerprint"][:12] in r["nudged"]
        assert ranks[1]["fingerprint"][:12] in r["nudged"]


def test_per_rank_clamp_misses_the_global_batch(ref, tmp_path):
    """The fault the global statistics repair: clamping with each rank's own
    mean and std. The outlier row lives on rank 1, whose clamp then lets
    through what the global one cuts."""
    got = run_ranks(step_job, 2, tmp_path, per_rank_clamp=True, **ref["job"])[0]
    worst = max(_grad_errors(got["grads"], ref["grads"]).values())
    assert worst > 10 * GRAD_REL_L2, worst


def test_fsdp_step_matches_and_its_checkpoint_loads_without_it(ref, tmp_path):
    env = ref["env"]
    start_file = str(tmp_path / "start.pt")
    plain = train_state_from_jax(ref["start"], env.tcfg)
    checkpoint.CheckpointIO(state=plain).save(start_file)   # written without FSDP
    end_file = str(tmp_path / "end.pt")
    got = run_ranks(step_job, 2, tmp_path, fsdp=True, start_ckpt=start_file,
                    save_ckpt=end_file, **ref["job"])[0]
    _hold_state(got["state"], ref)
    for js, ts in zip(ref["stats"], got["stats"]):
        for k in js:
            assert ts[k] == pytest.approx(js[k], rel=1e-4), k
    # The FSDP run's checkpoint: the layout without FSDP, and it loads there.
    saved = checkpoint.load_checkpoint(end_file)["state"]
    layout = plain.state_dict()
    assert sorted(saved) == sorted(layout)
    for key in ("params", "adam_m", "adam_v"):
        assert {n: t.shape for n, t in saved[key].items()} == {
            n: t.shape for n, t in layout[key].items()}
    checkpoint.CheckpointIO(state=plain).load(end_file)
    back = train_state_to_jax(plain)
    assert int(back["adam_step"]) == STEPS
    for key in ("params", "adam_m", "adam_v"):
        for n, a in _flat(back[key]).items():
            np.testing.assert_array_equal(a, _flat(got["state"][key])[n], err_msg=n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return scenes.make_synthetic_dataset(str(tmp_path_factory.mktemp("dist") / "scenes"),
                                         num_scenes=4, num_views=4, imsize=16)


NET = dict(img_resolution=16, model_channels=16, channel_mult=(1, 2), num_blocks=1,
           attn_resolutions=(8,), channels_per_head=8, use_bf16=False, remat=False)


@pytest.mark.parametrize("fsdp", [False, True], ids=["data_parallel", "fsdp"])
def test_trainer_on_two_ranks(data, tmp_path, fsdp):
    run_dir = str(tmp_path / "run")
    # Under FSDP with the presets' recompute of the decoder blocks.
    ranks = run_ranks(trainer_job, 2, tmp_path, run_dir=run_dir, data=data,
                      net_kwargs=dict(NET, remat=fsdp), steps=2, fsdp=fsdp)
    for r, got in enumerate(ranks):
        # This rank's rows: the JAX loader's over its process_index, one row
        # a step, the resumed run's continuing where the slice stopped.
        jdata = jopen_scene_dataset(data, seed=3, process_index=r, process_count=2)
        loader = jcollate.BatchLoader(iter(jdata), jcollate.DualSourceCollate(imsize=16, seed=3),
                                      batch_size=1, num_threads=1)
        try:
            want = [next(loader) for _ in range(4)]
        finally:
            loader.close()
        assert len(got["rows"]) == 4
        for a, b in zip(got["rows"], want):
            for k in b:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=f"rank {r} {k}")
        assert got["nimg"] == (24, 48) and got["steps"] == (2, 4)
        # Every status tick after a step counts both ranks' loss.
        assert got["counts"] == [2, 2, 2, 2]
    assert sorted(ranks[0]["writes"]) == sorted(   # checkpoints go through a .tmp file
        ["training-state-0000000.pt.tmp", "network-snapshot-0000000-0.050.pkl",
         "network-snapshot-0000000-0.100.pkl"] * 2
        + ["training-state-0000000.pt.tmp"] * 2)
    assert ranks[1]["writes"] == []
    assert not [f for f in os.listdir(run_dir) if f.endswith(".tmp")]


def test_seed_split_matches_jax(data, monkeypatch):
    """Rank r of 2: the same batches of seeds and the same scene rows as
    vivid_tpu/generate.py's split, with each package's rank and world size
    patched and its sampler replaced by the noise (no model runs)."""
    from vivid_tpu import generate as jgenerate
    from vivid_tpu.core import dist as jdist
    from vivid_tpu.nn import precond as jprecond
    from vivid_tpu_torch import generate
    from vivid_tpu_torch.core.easydict import EasyDict
    from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
    jcfg = jprecond.PrecondConfig(**NET)
    monkeypatch.setattr(jgenerate, "_build_sampler",
                        lambda *a, **k: lambda p, g, src, geo, noise, *r, **kw: noise)
    monkeypatch.setattr(generate, "edm_sampler", lambda denoise, noise, **kw: noise)
    monkeypatch.setattr(dist, "barrier", lambda name="barrier": None)
    net = EasyDict(net=NVPrecond(PrecondConfig(**NET)).eval(), cfg=PrecondConfig(**NET))
    seeds = list(range(11))
    for r in range(2):
        for mod in (jdist, dist):
            monkeypatch.setattr(mod, "get_rank", lambda r=r: r)
            monkeypatch.setattr(mod, "get_world_size", lambda: 2)
        want = list(jgenerate.generate_images_nvs(
            EasyDict(cfg=jcfg, params=None), seeds=seeds, max_batch_size=2,
            datakwargs={"path": data}, verbose=False))
        got = list(generate.generate_images_nvs(net, seeds=seeds, max_batch_size=2,
                                                datakwargs={"path": data}, verbose=False,
                                                device="cpu"))
        assert [list(b.seeds) for b in got] == [list(b.seeds) for b in want]
        assert sum(len(b.seeds) for b in got) == (6 if r == 0 else 5)
        # The scene rows of rank r: the JAX stream over its process_index
        # (read by one thread; the JAX generator's two threads may reorder).
        loader = jcollate.BatchLoader(
            iter(jopen_scene_dataset(data, seed=0, process_index=r, process_count=2)),
            jcollate.DualSourceCollate(imsize=16, seed=0), batch_size=2, num_threads=1)
        try:
            for b in got:
                np.testing.assert_array_equal(
                    b.src, np.asarray(next(loader)["src_image"])[:len(b.seeds), 0])
        finally:
            loader.close()


def test_metrics_moments_over_two_ranks_equal_one(data, tmp_path, monkeypatch):
    """The ranks' moments summed over the group equal the moments one
    process takes of the same images: both ranks' batches, sampled here
    rank by rank with the rank patched (each rank reads its own scenes)."""
    from vivid_tpu_torch.core.easydict import EasyDict
    from vivid_tpu_torch.generate import generate_images_nvs
    from vivid_tpu_torch.metrics.stats import calculate_stats_for_iterable_nvs
    from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
    from vivid_tpu_torch.train.snapshots import save_snapshot
    snap = str(tmp_path / "net.pkl")
    net = NVPrecond(PrecondConfig(**NET), seed=5)
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n.endswith("gain"):
                p.fill_(1.0)
    save_snapshot(snap, net)
    seeds = list(range(4))
    # gloo named for a card's device, as chip_smoke.py starts two ranks on one
    # card: the named backend, not the device's NCCL (no card is touched).
    ranks = run_ranks(metrics_job, 2, tmp_path, snapshot=snap, data=data, seeds=seeds,
                      num_steps=2, init_kwargs=dict(backend="gloo", device="cuda:0"))
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "barrier", lambda name="barrier": None)
    batches = []
    for rank in range(2):
        monkeypatch.setattr(dist, "get_rank", lambda rank=rank: rank)
        batches += [EasyDict(images=b.images, tgt=b.tgt, src=b.src)
                    for b in generate_images_nvs(net=snap, seeds=seeds, max_batch_size=2,
                                                 num_steps=2, datakwargs={"path": data},
                                                 device="cpu", verbose=False)]
    monkeypatch.undo()
    for r, ref_ in calculate_stats_for_iterable_nvs(batches, metrics=["stub_fid", "psnr"],
                                                    verbose=False, device="cpu"):
        pass
    for got in ranks:
        assert got["backend"] == "gloo"
        np.testing.assert_array_equal(got["summed"], [3.0, 20.0])
        assert got["moments"] == dict(num=2, mean=0.5, std=0.5)
        assert got["suspend"] is True and got["shared"] == {"from": 0}
        for mine, one in ((got["stats"], r.stats), (got["ref"], ref_.stats)):
            assert mine["num_images"] == one["num_images"] == 4
            for k in ("mu", "sigma"):
                np.testing.assert_allclose(mine["stub_fid"][k], one["stub_fid"][k],
                                           rtol=1e-9, atol=1e-12)
        assert got["stats"]["psnr"]["val"] == pytest.approx(r.stats["psnr"]["val"], rel=1e-12)


def test_entry_points_default_to_this_ranks_card(data, tmp_path, monkeypatch):
    """Under torchrun every process must take its own card, not card 0."""
    from vivid_tpu_torch.generate import generate_images_nvs
    from vivid_tpu_torch.metrics.detectors import resolve_device
    from vivid_tpu_torch.train.loop import training_loop
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert dist.default_device() == torch.device("cuda", 2) == resolve_device()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="local rank 2"):
        dist.default_device()
    asked = []
    monkeypatch.setattr(dist, "default_device",
                        lambda: asked.append(1) or torch.device("cpu"))
    training_loop(run_dir=str(tmp_path / "run"), dataset_kwargs={"path": data},
                  network_kwargs=NET, batch_size=2, max_steps=1, status_nimg=None,
                  snapshot_nimg=None, checkpoint_nimg=None, samples_nimg=None)
    snap = str(tmp_path / "net.pkl")
    from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
    from vivid_tpu_torch.train.snapshots import save_snapshot
    save_snapshot(snap, NVPrecond(PrecondConfig(**NET), seed=1))
    list(generate_images_nvs(net=snap, seeds=[0], max_batch_size=1, num_steps=1,
                             datakwargs={"path": data}, verbose=False))
    assert len(asked) == 2


def test_single_image_rows_on_two_ranks(data, tmp_path):
    """C-ref-9: the JAX package seeds every process's single images with
    seed + 2, so every rank draws the same rows. The port keeps rank 0's
    stream (the JAX package's rows) and folds the rank into the others'."""
    import PIL.Image
    from vivid_tpu.data.single_images import SingleImages as JSingleImages
    from vivid_tpu_torch.core.rngs import fold_in
    from vivid_tpu_torch.data.single_images import SingleImages
    singles = tmp_path / "singles"
    singles.mkdir()
    rs = np.random.RandomState(0)
    for i, shape in enumerate([(32, 48, 3), (48, 32, 3), (16, 24, 3)]):
        PIL.Image.fromarray(rs.randint(0, 255, shape, np.uint8)).save(singles / f"im{i}.png")
    ranks = run_ranks(single_rows_job, 2, tmp_path, run_dir=str(tmp_path / "run"), data=data,
                      singles=str(singles), net_kwargs=NET, steps=2)
    theirs = JSingleImages(str(singles), imsize=16, num_sources=2, seed=3 + 2)
    loader = jcollate.BatchLoader(iter(theirs), theirs, batch_size=1, num_threads=1)
    try:
        want = [next(loader) for _ in range(2)]
    finally:
        loader.close()
    ours = SingleImages(str(singles), imsize=16, num_sources=2, seed=fold_in(3 + 2, 1))
    rank1 = [ours.materialize(None, ours.sample_plan())[0] for _ in range(2)]
    assert [len(r) for r in ranks] == [2, 2]
    for mine, theirs_row, other, other_want in zip(ranks[0], want, ranks[1], rank1):
        assert sorted(mine) == sorted(theirs_row) == sorted(other)
        for k in theirs_row:
            np.testing.assert_array_equal(mine[k], np.asarray(theirs_row[k]), err_msg=k)
        for k in other_want:
            np.testing.assert_array_equal(other[k][0], other_want[k], err_msg=k)
    assert not all(np.array_equal(ranks[0][0][k], ranks[1][0][k]) for k in rank1[0])


def test_dist_init_makes_no_group_alone_and_never_falls_back(tmp_path, monkeypatch):
    """One process: no group. Several, with NCCL unable to start (a CPU
    device named for it, or no card for the default device): dist.init
    raises and no group of another backend is left."""
    import signal
    monkeypatch.setattr(signal, "signal", lambda *a: None)   # keep pytest's handlers
    store = f"file://{tmp_path / 'store'}"
    monkeypatch.setenv("VIVID_COORDINATOR", store)
    monkeypatch.setenv("VIVID_PROCESS_ID", "0")
    monkeypatch.setenv("VIVID_NUM_PROCESSES", "1")
    dist.init(device="cpu")
    assert not torch.distributed.is_initialized() and dist.get_world_size() == 1
    monkeypatch.setenv("VIVID_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        dist.init(backend="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dist.init()
    assert not torch.distributed.is_initialized()
    assert not os.path.exists(tmp_path / "store")


def test_step_refuses_unequal_shares_before_any_collective(monkeypatch):
    from vivid_tpu_torch.diffusion.loss import NVLoss
    from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
    cfg = step.TrainConfig(batch_size=4)
    state = step.init_train_state(NVPrecond(PrecondConfig(**NET), seed=0), cfg)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    collectives = []
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda *a, **k: collectives.append(1))
    fn = step.make_train_step(NVLoss(P_mean=-0.8, P_std=1.6), cfg, group=object())
    rs = np.random.RandomState(0)
    batch = dict(src=torch.from_numpy(rs.randn(3, 2, 16, 16, 3).astype(np.float32)),
                 tgt=torch.from_numpy(rs.randn(3, 16, 16, 3).astype(np.float32)),
                 geometry=torch.from_numpy(rs.randn(3, 2, 20).astype(np.float32)))
    with pytest.raises(ValueError, match="holds 3 rows of the global batch of 4 over 2"):
        fn(state, batch)
    assert collectives == [] and state.adam_step == 0
