"""The port's RealEstate10K reader against vivid_tpu's on a synthetic txt +
png tree: the native image library, `resize_image`, `parse_line`, the
scene stream for one seed (frame choice, poses, intrinsics and pixels bitwise,
with and without a frame range), dual-source rows from it, the item
dataset, the dataset factory, `convert re10k`; and three repairs of the
port: the native resize, the trainer's test split, `range_selection`
reaching the dataset."""

import os

import numpy as np
import PIL.Image
import pytest
import torch

from vivid_tpu.data import collate as jcollate, convert as jconvert, re10k as jre10k
from vivid_tpu.data import re10k_scenes as jscenes, scenes as jnpz
from vivid_tpu.native import fast_image as jfast
from vivid_tpu_torch.data import collate, convert, re10k, re10k_scenes, scenes
from vivid_tpu_torch.native import fast_image
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train.snapshots import save_snapshot

torch.set_num_threads(1)

TINY = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,),
            channels_per_head=8, use_bf16=False)


def make_re10k_tree(root, splits=("train",), num_seqs=3, num_frames=72, w=48, h=27, seed=0):
    """A RealEstate10K-layout tree: `RealEstate10K/<split>/<seq>.txt` camera
    files (a URL line, then timestamp, normalised intrinsics, two zeros and a
    3 x 4 world-to-camera pose a frame) beside `<split>/<seq>/<ts>.png`."""
    rng = np.random.RandomState(seed)
    for split in splits:
        seq_dir = os.path.join(root, "RealEstate10K", split)
        os.makedirs(seq_dir, exist_ok=True)
        for s in range(num_seqs):
            seq = f"{split}{s:03d}"
            frame_dir = os.path.join(root, split, seq)
            os.makedirs(frame_dir, exist_ok=True)
            lines = ["https://example.com/video"]
            for f in range(num_frames):
                ts = str(1000 + f)
                angle = 0.01 * f + 0.1 * s
                c, si = np.cos(angle), np.sin(angle)
                pose = [c, 0, si, 0.05 * f, 0, 1, 0, 0.01 * f, -si, 0, c, 0.02 * f]
                lines.append(" ".join([ts, "0.9", "1.6", "0.5", "0.5", "0", "0"]
                                      + [f"{v:.6f}" for v in pose]))
                PIL.Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8), "RGB").save(
                    os.path.join(frame_dir, ts + ".png"))
            with open(os.path.join(seq_dir, seq + ".txt"), "w") as fh:
                fh.write("\n".join(lines))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_re10k_tree(str(tmp_path_factory.mktemp("re10k")), splits=("train", "test"))


@pytest.mark.parametrize("shape,size", [((360, 360), 64), ((360, 360), 256), ((360, 640), 64),
                                        ((256, 256), 64), ((128, 128), 32), ((40, 40), 64)])
def test_resize_image_matches_jax(shape, size):
    """Bitwise at non-whole sizes (a RealEstate10K crop to 64 and 256 px, a
    whole 640 x 360 frame, an upscale) and at whole factors."""
    img = np.random.RandomState(size + shape[1]).randint(0, 256, shape + (3,), np.uint8)
    want = jcollate.resize_image(img, size)
    got = collate.resize_image(img, size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_resize_image_without_native_matches_jax(monkeypatch):
    monkeypatch.setenv("VIVID_NO_NATIVE", "1")
    img = np.random.RandomState(1).randint(0, 256, (90, 90, 3), np.uint8)
    np.testing.assert_array_equal(collate.resize_image(img, 32),
                                  np.asarray(PIL.Image.fromarray(img).resize(
                                      (32, 32), PIL.Image.Resampling.BILINEAR), np.float32))
    np.testing.assert_array_equal(collate.resize_image(img, 45),
                                  img.reshape(45, 2, 45, 2, 3).mean(axis=(1, 3), dtype=np.float32))


def test_native_library_matches_jax(tree):
    frame_dir = os.path.join(tree, "train", "train000")
    path = os.path.join(frame_dir, sorted(os.listdir(frame_dir))[0])
    assert fast_image.probe_dims(path) == jfast.probe_dims(path) == (27, 48)
    np.testing.assert_array_equal(fast_image.load_rgb(path), jfast.load_rgb(path))
    img = fast_image.load_rgb(path)
    np.testing.assert_array_equal(fast_image.resize_bilinear_u8(img, 20),
                                  jfast.resize_bilinear_u8(img, 20))
    np.testing.assert_array_equal(fast_image.resize_box_u8(img[:24, :24], 3),
                                  jfast.resize_box_u8(img[:24, :24], 3))
    assert fast_image.library() is fast_image.library()
    assert str(fast_image.BUILD_DIR).endswith(os.path.join("build", "native"))


def test_parse_line_and_transform_coordinates_match_jax():
    line = "100 0.9 1.6 0.5 0.45 0 0 " + " ".join(f"{0.1 * i:.2f}" for i in range(12))
    for got, want in zip(re10k.parse_line(line), jre10k.parse_line(line)):
        np.testing.assert_array_equal(got, want)
    K = np.array([[576.0, 0, 320.0], [0, 576.0, 180.0], [0, 0, 1]])
    for size in (64, 256):
        np.testing.assert_array_equal(re10k.transform_coordinates(K, size, 360),
                                      jre10k.transform_coordinates(K, size, 360))


@pytest.mark.parametrize("range_selection", [None, "mid", "long"])
def test_scene_stream_matches_jax(tree, range_selection):
    kw = dict(split="train", views_per_scene=6, range_selection=range_selection, seed=5)
    ours = iter(re10k_scenes.RealEstate10KScenes(tree, **kw))
    theirs = iter(jscenes.RealEstate10KScenes(tree, **kw))
    for _ in range(5):
        a, b = next(ours), next(theirs)
        assert a["image"].paths == b["image"].paths
        assert a["image"].crops == b["image"].crops and a["image"].shape == b["image"].shape
        for key in ("c2w", "fxfycxcy"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(np.asarray(a["image"]), np.asarray(b["image"]))
    if range_selection is not None:   # frames of a scene lie within the range's window
        idx = [int(os.path.basename(p)[:-4]) - 1000 for p in a["image"].paths]
        assert max(idx) - min(idx) >= 2 and len(idx) == 6


def test_dual_source_rows_match_jax(tree):
    kw = dict(split="train", views_per_scene=8, range_selection="mid", seed=2)
    ours = collate.BatchLoader(iter(re10k_scenes.RealEstate10KScenes(tree, **kw)),
                               collate.DualSourceCollate(imsize=16, sr_size=32, seed=3),
                               batch_size=4, prefetch=1)
    theirs = jcollate.BatchLoader(iter(jscenes.RealEstate10KScenes(tree, **kw)),
                                  jcollate.DualSourceCollate(imsize=16, sr_size=32, seed=3),
                                  batch_size=4, prefetch=1, num_threads=1)
    try:
        for _ in range(2):
            a, b = next(ours), next(theirs)
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    finally:
        ours.close()
        theirs.close()


def test_item_dataset_matches_jax(tree):
    from vivid_tpu_torch.core.registry import get_obj_by_name
    for name in ("datautils.RealEstate10K", "vivid_tpu.data.re10k.RealEstate10K"):
        assert get_obj_by_name(name) is re10k.RealEstate10K
    for rs in (None, "mid"):
        ours = re10k.RealEstate10K(split="train", imsize=8, data_root=tree, sr_mult=2,
                                   range_selection=rs, seed=4)
        theirs = jre10k.RealEstate10K(split="train", imsize=8, data_root=tree, sr_mult=2,
                                      range_selection=rs, seed=4)
        assert ours.sequence_paths == theirs.sequence_paths and len(ours) == 3
        for a, b in zip([ours[1], next(iter(ours))], [theirs[1], next(iter(theirs))]):
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_factory_dispatch(tree, tmp_path):
    ds = re10k_scenes.open_scene_dataset(tree, split="test", seed=1, range_selection="mid")
    assert isinstance(ds, re10k_scenes.RealEstate10KScenes)
    assert ds.files == jscenes.open_scene_dataset(tree, split="test").files
    ds = re10k_scenes.open_scene_dataset(os.path.join(tree, "RealEstate10K"), split="train")
    assert isinstance(ds, re10k_scenes.RealEstate10KScenes) and len(ds) == 3
    npz = scenes.make_synthetic_dataset(str(tmp_path / "npz"), num_scenes=3, num_views=4,
                                        imsize=16)
    ds = re10k_scenes.open_scene_dataset(npz, split="test", range_selection="mid",
                                         views_per_scene=4, seed=2, shuffle=False,
                                         process_index=1, process_count=2)
    want = jscenes.open_scene_dataset(npz, split="test", range_selection="mid", seed=2,
                                      shuffle=False, process_index=1, process_count=2)
    assert isinstance(ds, scenes.SceneDataset) and isinstance(want, jnpz.SceneDataset)
    np.testing.assert_array_equal(np.asarray(next(iter(ds))["image"]),
                                  np.asarray(next(iter(want))["image"]))
    for path in (npz, tree):
        with pytest.raises(ValueError, match="crop_mode"):
            re10k_scenes.open_scene_dataset(path, crop_mode="x")


def test_npz_stream_sharded_like_jax(tmp_path):
    npz = scenes.make_synthetic_dataset(str(tmp_path / "npz"), num_scenes=5, num_views=3,
                                        imsize=8)
    for kw in (dict(seed=3), dict(seed=3, shuffle=False), dict(seed=1, process_index=1,
                                                                process_count=2)):
        ours, theirs = iter(scenes.SceneDataset(npz, **kw)), iter(jnpz.SceneDataset(npz, **kw))
        for _ in range(6):
            np.testing.assert_array_equal(np.asarray(next(ours)["image"]),
                                          np.asarray(next(theirs)["image"]))


def test_convert_re10k_matches_jax(tree, tmp_path):
    args = ["--src", tree, "--split", "test", "--max-scenes", "2"]
    convert.cmdline(["re10k", *args, "--dst", str(tmp_path / "ours")], standalone_mode=False)
    jconvert.cmdline(["re10k", *args, "--dst", str(tmp_path / "theirs")], standalone_mode=False)
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == names and len(names) == 2
    for name in names:
        with np.load(tmp_path / "ours" / name) as a, np.load(tmp_path / "theirs" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_inspect_dataset_reads_re10k(tree, tmp_path):
    from vivid_tpu_torch.cli import inspect_dataset
    n = inspect_dataset.main(["--data", tree, "--outdir", str(tmp_path), "--num-scenes", "2"],
                             standalone_mode=False)
    assert n == 2 and PIL.Image.open(tmp_path / "scene_000.png").size == (3 * 27, 27)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("re10k_net") / "net.pkl")
    save_snapshot(path, NVPrecond(PrecondConfig(img_resolution=16, **TINY), seed=0))
    return path


def test_range_selection_reaches_the_stream(tree, snapshot):
    """generate_images_nvs hands `range_selection` to the RealEstate10K
    stream: its sources and targets are the rows of a 'mid' stream for the
    same seed (of the test split, which sampling reads), not those of an
    unconstrained one."""
    from vivid_tpu_torch.generate import generate_images_nvs
    (batch,) = generate_images_nvs(snapshot, seeds=range(4), max_batch_size=4, num_steps=1,
                                   range_selection="mid", rng_seed=7, verbose=False,
                                   device="cpu", datakwargs={"path": tree})

    def rows(rs):
        loader = collate.BatchLoader(
            iter(re10k_scenes.open_scene_dataset(tree, seed=7, split="test", range_selection=rs)),
            collate.DualSourceCollate(16, seed=7), batch_size=4)
        try:
            return next(loader)
        finally:
            loader.close()

    mid, free = rows("mid"), rows(None)
    np.testing.assert_array_equal(batch.tgt, mid["tgt_image"])
    np.testing.assert_array_equal(batch.src, mid["src_image"][:, 0])
    assert not np.array_equal(batch.tgt, free["tgt_image"])


def _first_rows(tree, split, seed=7):
    loader = collate.BatchLoader(
        iter(re10k_scenes.open_scene_dataset(tree, seed=seed, split=split)),
        collate.DualSourceCollate(16, seed=seed), batch_size=4)
    try:
        return next(loader)
    finally:
        loader.close()


@pytest.mark.parametrize("split", [None, "train", "test"])
def test_sampling_reads_the_test_split(tree, snapshot, split):
    """generate_images_nvs (and so the generation CLI and `calculate_metrics
    gen`) reads a RealEstate10K tree's test split unless `datakwargs` names
    another, as the reference's generator does; the JAX package reads the
    train split (ROADMAP C9, C-ref-6)."""
    from vivid_tpu_torch.generate import generate_images_nvs
    datakwargs = {"path": tree} if split is None else {"path": tree, "split": split}
    (batch,) = generate_images_nvs(snapshot, seeds=range(4), max_batch_size=4, num_steps=1,
                                   rng_seed=7, verbose=False, device="cpu",
                                   datakwargs=datakwargs)
    want, other = _first_rows(tree, split or "test"), _first_rows(
        tree, "train" if split in (None, "test") else "test")
    np.testing.assert_array_equal(batch.tgt, want["tgt_image"])
    np.testing.assert_array_equal(batch.src, want["src_image"][:, 0])
    assert not np.array_equal(batch.tgt, other["tgt_image"])


def test_range_selection_dropped_on_npz(snapshot, tmp_path):
    from vivid_tpu_torch.generate import generate_images_nvs
    npz = scenes.make_synthetic_dataset(str(tmp_path / "npz"), num_scenes=2, num_views=4,
                                        imsize=16)
    runs = [list(generate_images_nvs(snapshot, seeds=range(2), max_batch_size=2, num_steps=1,
                                     range_selection=rs, verbose=False, device="cpu",
                                     datakwargs={"path": npz})) for rs in ("mid", None)]
    np.testing.assert_array_equal(runs[0][0].images, runs[1][0].images)


def test_trainer_metrics_tick_reads_the_test_split(tree, tmp_path, monkeypatch):
    """The trainer's metrics tick hands the test split to the metrics with
    its test tree (train/loop.py's `test_split`; the JAX tick names no
    split)."""
    from vivid_tpu_torch.metrics import api
    from vivid_tpu_torch.train.loop import training_loop
    seen = []
    monkeypatch.setattr(api, "get_metrics", lambda net, **kw: seen.append(kw) or {"psnr": 0.0})
    data = scenes.make_synthetic_dataset(str(tmp_path / "npz"), num_scenes=2, num_views=4,
                                         imsize=16)
    training_loop(run_dir=str(tmp_path / "run"), dataset_kwargs={"path": data},
                  test_dataset_path=tree, network_kwargs=dict(TINY, img_resolution=16, remat=False),
                  loss_kwargs=dict(P_mean=-0.8, P_std=1.6),
                  lr_kwargs=dict(ref_lr=1e-3, rampup_Mimg=0), batch_size=2, eval_samples=0,
                  status_nimg=None, samples_nimg=None, metrics_nimg=12, snapshot_nimg=None,
                  checkpoint_nimg=None, max_steps=1, device="cpu")
    assert seen and all(kw["datakwargs"] == {"path": tree, "split": "test"} for kw in seen)


def test_trainer_reads_the_test_split(tree, tmp_path):
    """The sample grid's rows come from the test split of a RealEstate10K
    tree (its train split holds other sequences; a tree with only a test
    split fails to open as train)."""
    from vivid_tpu_torch.train.loop import training_loop
    test_only = make_re10k_tree(str(tmp_path / "test_only"), splits=("test",), num_seqs=2,
                                num_frames=6, seed=3)
    data = scenes.make_synthetic_dataset(str(tmp_path / "npz"), num_scenes=2, num_views=4,
                                         imsize=16)
    net = dict(TINY, img_resolution=16, remat=False)
    training_loop(run_dir=str(tmp_path / "run"), dataset_kwargs={"path": data},
                  test_dataset_path=test_only, network_kwargs=net,
                  loss_kwargs=dict(P_mean=-0.8, P_std=1.6),
                  lr_kwargs=dict(ref_lr=1e-3, rampup_Mimg=0), batch_size=2, eval_samples=2,
                  status_nimg=None, samples_nimg=12, snapshot_nimg=None, checkpoint_nimg=None,
                  max_steps=1, device="cpu")
    grid = np.asarray(PIL.Image.open(tmp_path / "run" / "results" /
                                     "generated-samples-0000000.png"))
    loader = collate.BatchLoader(
        iter(re10k_scenes.open_scene_dataset(test_only, seed=1, split="test")),
        collate.DualSourceCollate(16, seed=1), batch_size=2)
    try:
        want = next(loader)
    finally:
        loader.close()
    np.testing.assert_array_equal(grid[:16], np.concatenate(
        list(np.clip(want["src_image"][:, 0], 0, 255).astype(np.uint8)), axis=1))
