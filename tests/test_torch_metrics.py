"""The port's metrics against vivid_tpu's on the same seeded inputs: the
InceptionV3 features on the JAX package's `init_params` tree carried across
(made input-sensitive; three planted faults must fail the check),
TF1's bilinear resize, a tiny DINOv2 ViT (class token and `out_indices`
maps), loading an original-naming state dict, DINOv2's preprocessing, the
fp64 feature moments with the stub detector and PSNR, the Fréchet distance,
`calc` with `--dest` / `--ref`; the port alone: the detectors' missing-weight
errors and random mode, a tiny `gen` on a RealEstate10K tree, and the
trainer's metrics tick (its `Metrics:` lines in log.txt; nothing on a rank
whose results are None)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from vivid_tpu.core.easydict import EasyDict as JEasyDict
from vivid_tpu.metrics import frechet as jfrechet, inception_jax, stats as jstats
from vivid_tpu.metrics.dinov2_jax import preprocess_jax
from vivid_tpu.nn import dinov2 as jdinov2
from vivid_tpu_torch.cli import calculate_metrics
from vivid_tpu_torch.compat.from_jax import inception_from_jax, vit_from_jax
from vivid_tpu_torch.core import dist
from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.data import scenes
from vivid_tpu_torch.metrics import detectors, dinov2, frechet, inception, stats
from vivid_tpu_torch.nn import dinov2 as vit
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train.snapshots import save_snapshot

from test_torch_re10k import TINY, make_re10k_tree

torch.set_num_threads(1)

VIT = vit.ViTConfig(embed_dim=48, depth=2, num_heads=2, patch_size=14)
STUB_METRICS = ["stub_fid", "joint_stub_fid", "psnr"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


INCEPTION_REL = 1e-4   # relative L2 of the port's fp32 features to the JAX package's


@pytest.fixture(scope="module")
def inception_case():
    """JAX's random InceptionV3 tree made input-sensitive, and its fp32
    features of 2 images. `init_params`' own scales leave pool3 almost blind
    to its input (two images differ by ~3e-5 relative): here each conv
    weight is scaled by sqrt(2) (He's gain) and the batch norms' mean and
    beta are 0, so that the input reaches pool3."""
    params = {name: dict(w=np.asarray(p["w"]) * np.float32(np.sqrt(2.0)),
                         mean=np.zeros_like(p["mean"]), var=np.asarray(p["var"]),
                         beta=np.zeros_like(p["beta"]))
              for name, p in inception_jax.init_params(jax.random.PRNGKey(0)).items()}
    imgs = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3), np.uint8)
    want = np.asarray(inception_jax.inception_features(params, imgs, use_bf16=False))
    return params, imgs, want


def _port_inception(params, imgs):
    model = inception.InceptionV3()
    model.load_state_dict(inception_from_jax(params), strict=True)
    return model.eval()(torch.from_numpy(imgs)).numpy()


def test_inception_matches_jax(inception_case):
    params, imgs, want = inception_case
    got = _port_inception(params, imgs)
    assert got.shape == want.shape == (2, inception.FEATURE_DIM)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())
    between_images = _rel(want[::-1], want)
    assert _rel(got, want) < INCEPTION_REL < between_images / 100, between_images


def _half_pixel_resize(x, h, w):
    return torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1)


def _pool_counting_padding(kind, x, k, stride, pad, real_pool=inception.pool):
    if kind == "avg" and pad == "SAME":
        return torch.nn.functional.avg_pool2d(x, k, stride, padding=(k[0] // 2, k[1] // 2),
                                              count_include_pad=True)
    return real_pool(kind, x, k, stride, pad)


@pytest.mark.parametrize("fault", ["half_pixel_resize", "pools_count_padding",
                                   "square_kernels_transposed"])
def test_inception_check_catches_fault(inception_case, monkeypatch, fault):
    """Each planted fault moves the port's features off the JAX package's
    by more than test_inception_matches_jax's limit."""
    params, imgs, want = inception_case
    if fault == "half_pixel_resize":
        monkeypatch.setattr(inception, "tf1_resize_bilinear", _half_pixel_resize)
    elif fault == "pools_count_padding":
        monkeypatch.setattr(inception, "pool", _pool_counting_padding)
    else:
        params = {name: dict(p, w=p["w"].transpose(1, 0, 2, 3)
                             if p["w"].shape[0] == p["w"].shape[1] > 1 else p["w"])
                  for name, p in params.items()}
    assert _rel(_port_inception(params, imgs), want) > INCEPTION_REL


def test_inception_spec_and_pools():
    """The spec is the JAX package's; every SAME pool is symmetric (so
    count_include_pad=False is TF's valid-cell count) and every SAME conv is
    stride 1."""
    assert inception.INCEPTION_V3_SPEC == inception_jax.INCEPTION_V3_SPEC
    assert inception.iter_convs() == inception_jax.iter_convs()
    for name, _, _, k, s, pad in inception.iter_convs():
        assert pad == "VALID" or (s == 1 and k[0] % 2 and k[1] % 2), name

    def pools(spec):
        for node in spec:
            if node[0] in ("max", "avg"):
                yield node
            elif node[0] == "fan":
                for br in node[1]:
                    yield from pools(br)

    for kind, k, s, pad in pools(inception.INCEPTION_V3_SPEC):
        assert pad == "VALID" or (kind, k, s) == ("avg", (3, 3), 1)
    x = torch.arange(2 * 3 * 5 * 5, dtype=torch.float32).reshape(2, 3, 5, 5)
    y = inception.pool("avg", x, (3, 3), 1, "SAME")
    np.testing.assert_allclose(y[0, 0, 0, 0].item(), x[0, 0, :2, :2].mean().item(), rtol=1e-6)
    y = inception.pool("max", -x, (2, 2), 2, "SAME")   # pads with -inf, not 0
    assert y.shape == (2, 3, 3, 3) and y[0, 0, 2, 2].item() == -x[0, 0, 4, 4].item()


@pytest.mark.parametrize("in_hw,out_hw", [((64, 64), (299, 299)), ((256, 256), (299, 299)),
                                          ((299, 299), (150, 75)), ((40, 56), (299, 299))])
def test_tf1_resize_matches_jax(in_hw, out_hw):
    x = np.random.RandomState(sum(in_hw)).randint(0, 256, (2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(inception_jax.tf1_resize_bilinear(x, *out_hw))
    got = inception.tf1_resize_bilinear(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _vit_state_dict(num_tokens, seed=0):
    rng = np.random.RandomState(seed)
    sd = {}
    for k, shape in jdinov2.expected_vit_shapes(jdinov2.ViTConfig(48, 2, 2, 14),
                                                num_tokens).items():
        v = rng.randn(*shape).astype(np.float32) * 0.2
        if k.endswith(("gamma", "norm1.weight", "norm2.weight")) or k == "norm.weight":
            v += 1.0
        sd[k] = torch.from_numpy(v)
    return sd


@pytest.mark.parametrize("out_indices", [None, (0, 1)])
def test_vit_matches_jax(out_indices):
    """A tiny ViT (depth 2, dim 48, 2 heads, patch 14) on the JAX tree carried
    across: the class token and patch mean, or the `out_indices` maps."""
    jcfg = jdinov2.ViTConfig(48, 2, 2, 14)
    tree = jdinov2.params_from_state_dict(_vit_state_dict(26), jcfg, pos_grid=3)
    x = np.random.RandomState(1).randn(2, 42, 42, 3).astype(np.float32)
    want = jdinov2.vit_forward(tree, jcfg, jnp.asarray(x), out_indices=out_indices)
    model = vit.DinoViT(VIT, grid=3)
    model.load_state_dict(vit_from_jax(jax.tree.map(np.asarray, tree)), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2), out_indices=out_indices)
    if out_indices is not None:
        assert got[1] == want[1] == (3, 3)
        got, want = got[0], want[0]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) < 1e-5


def test_vit_loads_original_state_dict_like_jax():
    """An original-naming state dict with a 5 x 5 grid (and the pretraining's
    mask_token) loads into a 3 x 3 model as params_from_state_dict reads it."""
    sd = _vit_state_dict(26, seed=2)
    jcfg = jdinov2.ViTConfig(48, 2, 2, 14)
    tree = jdinov2.params_from_state_dict(sd, jcfg, pos_grid=3)
    model = vit.load_original_state_dict(vit.DinoViT(VIT, grid=3),
                                         dict(sd, mask_token=torch.zeros(1, 48)))
    np.testing.assert_array_equal(model.pos_embed[0].detach().numpy(), tree["pos_embed"])
    np.testing.assert_array_equal(model.blocks[1].attn.qkv.weight[48:96].detach().numpy(),
                                  np.asarray(tree["blocks"][1]["k"]["w"]).T)
    prefixed = {"pretrained." + k: v for k, v in sd.items()}
    again = vit.load_original_state_dict(vit.DinoViT(VIT, grid=3), prefixed, "pretrained.")
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="pos_embed"):
        model(torch.zeros(1, 3, 70, 70))


def test_dinov2_preprocess_matches_jax():
    imgs = np.random.default_rng(7).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    want = np.asarray(preprocess_jax(jnp.asarray(imgs, jnp.float32)))
    got = dinov2.preprocess(torch.from_numpy(imgs)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _image_batches(seed=0, n_batches=3, batch=4, size=32):
    rng = np.random.RandomState(seed)
    return [dict(images=rng.randint(0, 256, (batch, size, size, 3)).astype(np.uint8),
                 tgt=rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32),
                 src=rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32))
            for _ in range(n_batches)]


class _Iterable:
    def __init__(self, batches, easydict):
        self.batches = [easydict(b) for b in batches]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _last(stats_iter):
    for r, ref in stats_iter:
        pass
    return r, ref


def test_stats_moments_match_jax():
    """Generated, target and joint moments with the stub detector, and PSNR,
    on one fixed image iterable: the same fp64 numbers as the JAX package's."""
    batches = _image_batches()
    r, ref = _last(stats.calculate_stats_for_iterable_nvs(
        _Iterable(batches, EasyDict), metrics=STUB_METRICS, verbose=False))
    jr, jref = _last(jstats.calculate_stats_for_iterable_nvs(
        _Iterable(batches, JEasyDict), metrics=STUB_METRICS, verbose=False))
    assert r.num_images == jr.num_images == 12 and ref.num_images == 12
    for ours, theirs in ((r.stats, jr.stats), (ref.stats, jref.stats)):
        assert sorted(ours) == sorted(theirs)
        for metric in ("stub_fid", "joint_stub_fid"):
            for key in ("mu", "sigma"):
                np.testing.assert_allclose(ours[metric][key], theirs[metric][key],
                                           rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(r.stats["psnr"]["val"], jr.stats["psnr"]["val"], rtol=1e-14)
    assert r.stats["joint_stub_fid"]["mu"].shape == (128,)
    got = frechet.calculate_metrics_from_stats_nvs(r.stats, ref.stats, STUB_METRICS,
                                                   verbose=False)
    want = jfrechet.calculate_metrics_from_stats_nvs(jr.stats, jref.stats, STUB_METRICS,
                                                     verbose=False)
    assert sorted(got) == sorted(want) == sorted(STUB_METRICS)
    for k in got:   # 12 images in 64 dimensions: sqrtm's rounding on singular input
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        assert np.isfinite(got[k])
    assert got == frechet.calculate_metrics_from_stats_nvs(jr.stats, jref.stats, STUB_METRICS,
                                                           verbose=False)
    with pytest.raises(ValueError, match="requires stub_fid"):
        stats.calculate_stats_for_iterable_nvs(_Iterable(batches, EasyDict),
                                               metrics=["joint_stub_fid"], verbose=False)


@pytest.mark.parametrize("n,d", [(200, 64), (2000, 256)])
def test_frechet_distance_matches_jax(n, d):
    """Full-rank covariances: the eigenvalue form against the JAX package's
    scipy.linalg.sqrtm."""
    rng = np.random.RandomState(n)
    a, b = rng.randn(n, d), rng.randn(n, d) * 1.3 + 0.2
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    got, want = frechet.frechet_distance(*args), jfrechet.frechet_distance(*args)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("n,d", [(3, 64), (16, 512)])
def test_frechet_distance_of_singular_covariances(n, d):
    """Fewer samples than dimensions: the covariances X'X / (n - 1) are
    singular, and tr sqrtm(S1 S2) is exactly the sum of the singular values
    of X Y' / (n - 1) (the nonzero eigenvalues of S1 S2 are those of
    (X Y')(Y X') / (n - 1)^2). The port holds that to 1e-10; the JAX
    package's sqrtm is off it by its own rounding on singular input."""
    rng = np.random.RandomState(n + d)
    a, b = rng.randn(n, d), rng.randn(n, d) * 1.3 + 0.2
    x, y = a - a.mean(0), b - b.mean(0)
    s1, s2 = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    exact = (np.square(a.mean(0) - b.mean(0)).sum() + np.trace(s1) + np.trace(s2)
             - 2 * np.linalg.svd(x @ y.T, compute_uv=False).sum() / (n - 1))
    got = frechet.frechet_distance(a.mean(0), s1, b.mean(0), s2)
    np.testing.assert_allclose(got, exact, rtol=1e-10)
    want = jfrechet.frechet_distance(a.mean(0), s1, b.mean(0), s2)
    assert abs(want - exact) <= 1e-6 * abs(exact)
    assert abs(frechet.frechet_distance(a.mean(0), s1, a.mean(0), s1)) <= 1e-6 * np.trace(s1)


def _write_triplets(path, seeds, size=32, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    for s in seeds:
        for prefix in ("src", "tgt", "sample"):
            PIL.Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8)).save(
                os.path.join(path, f"{prefix}_{s:06d}.png"))
    return path


def test_calc_cli_matches_jax_and_round_trips(tmp_path):
    from vivid_tpu.cli.calculate_metrics import ImageFolderIterable as JFolder
    images = _write_triplets(str(tmp_path / "images"), range(5))
    dest = str(tmp_path / "stats.pkl")
    metrics = ",".join(STUB_METRICS)
    got = calculate_metrics.cmdline(["calc", "--images", images, "--metrics", metrics,
                                     "--batch", "2", "--dest", dest, "--device", "cpu"],
                                    standalone_mode=False)
    jr, jref = _last(jstats.calculate_stats_for_iterable_nvs(
        JFolder(images, max_batch_size=2), metrics=STUB_METRICS, verbose=False))
    want = jfrechet.calculate_metrics_from_stats_nvs(jr.stats, jref.stats, STUB_METRICS,
                                                     verbose=False)
    assert sorted(got) == sorted(want)
    for k in got:   # 5 images: singular covariances, as in test_stats_moments_match_jax
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    saved = stats.load_stats(dest)
    np.testing.assert_array_equal(saved["stub_fid"]["sigma"], jr.stats["stub_fid"]["sigma"])
    again = calculate_metrics.cmdline(["calc", "--images", images, "--metrics", metrics,
                                       "--batch", "3", "--ref", dest, "--device", "cpu"],
                                      standalone_mode=False)
    assert abs(again["stub_fid"]) < 1e-6 * got["stub_fid"]
    assert again["psnr"] == pytest.approx(got["psnr"], rel=1e-12)


def test_detectors_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("VIVID_DETECTOR_DIR", str(tmp_path))
    monkeypatch.delenv("VIVID_ALLOW_RANDOM_DETECTOR", raising=False)
    with pytest.raises(FileNotFoundError, match="inception-2015-12-05.pkl"):
        detectors.InceptionV3Detector(device="cpu")
    with pytest.raises(FileNotFoundError, match="dinov2_vitl14"):
        detectors.DINOv2Detector(device="cpu")
    assert dinov2.find_checkpoint(str(tmp_path)) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            detectors.InceptionV3Detector()


def test_random_inception_detector(monkeypatch):
    monkeypatch.setenv("VIVID_ALLOW_RANDOM_DETECTOR", "1")
    with pytest.warns(UserWarning, match="RANDOM weights"):
        det = detectors.InceptionV3Detector(device="cpu")
    assert not det.model.use_bf16
    x = np.random.RandomState(3).uniform(0, 255, (2, 16, 16, 3)).astype(np.float32)
    f = det(x)
    assert f.shape == (2, 2048) and f.dtype == np.float32 and np.isfinite(f).all()
    np.testing.assert_array_equal(f, det(x.astype(np.uint8)))   # pixels cast as JAX casts them
    again = inception.InceptionV3().init_random(seed=0)
    assert torch.equal(again.convs["Mixed_7c/Branch_3/Conv2d_0b_1x1"].var,
                       det.model.convs["Mixed_7c/Branch_3/Conv2d_0b_1x1"].var)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics_nets")
    paths = {}
    for name, extra, seed in (("base", {}, 0), ("uncond", {"uncond": True}, 1)):
        paths[name] = str(root / f"{name}.pkl")
        save_snapshot(paths[name], NVPrecond(PrecondConfig(img_resolution=16, **TINY, **extra),
                                             seed=seed))
    paths["tree"] = make_re10k_tree(str(root / "re10k"), splits=("train", "test"),
                                    num_seqs=2, num_frames=40)
    return paths


def _short_sampler(monkeypatch, num_steps=2):
    """`gen` samples through generate_images_nvs at `num_steps` steps (the
    CLI's 32, as the JAX package's, would make the CPU run long)."""
    from vivid_tpu_torch import generate
    real = generate.generate_images_nvs
    monkeypatch.setattr(generate, "generate_images_nvs",
                        lambda *a, **kw: real(*a, **dict(kw, num_steps=num_steps)))


def test_gen_cli_on_re10k(nets, tmp_path, monkeypatch):
    """A tiny guided `gen` on a RealEstate10K tree: the metrics' keys and
    finite values, the PNG triplets, and `calc` of the saved images against
    the `--dest` statistics of the same images."""
    _short_sampler(monkeypatch)
    out, dest = str(tmp_path / "out"), str(tmp_path / "gen.pkl")
    results = calculate_metrics.cmdline(
        ["gen", "--net", nets["base"], "--gnet", nets["uncond"], "--guidance", "1.5",
         "--data", nets["tree"], "--metrics", ",".join(STUB_METRICS), "--num", "4",
         "--batch", "2", "--range-selection", "mid", "--outdir", out,
         "--dest", dest, "--device", "cpu"], standalone_mode=False)
    assert sorted(results) == sorted(STUB_METRICS)
    assert all(np.isfinite(v) for v in results.values()) and results["stub_fid"] > 0
    assert len([f for f in os.listdir(out) if f.startswith("sample_")]) == 4
    again = calculate_metrics.cmdline(
        ["calc", "--images", out, "--metrics", ",".join(STUB_METRICS), "--ref", dest,
         "--batch", "2", "--device", "cpu"], standalone_mode=False)
    assert abs(again["stub_fid"]) < 1e-6 * results["stub_fid"]


def _trainer(run_dir, data, test_tree, **kw):
    from vivid_tpu_torch.train.loop import training_loop
    return training_loop(
        run_dir=str(run_dir), dataset_kwargs={"path": data}, test_dataset_path=test_tree,
        network_kwargs=dict(TINY, img_resolution=16, remat=False),
        loss_kwargs=dict(P_mean=-0.8, P_std=1.6), lr_kwargs=dict(ref_lr=1e-3, rampup_Mimg=0),
        batch_size=2, status_nimg=12, samples_nimg=None, snapshot_nimg=None,
        checkpoint_nimg=None, metrics_nimg=24, metrics_list=["stub_fid", "psnr"],
        max_steps=3, device="cpu", **kw)


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    return scenes.make_synthetic_dataset(str(tmp_path_factory.mktemp("metrics_scenes")),
                                         num_scenes=2, num_views=4, imsize=16)


def _tick_get_metrics(monkeypatch):
    """get_metrics at 4 images a tick and 2 sampling steps, to keep the CPU run short."""
    from vivid_tpu_torch.metrics import api
    real = api.get_metrics

    def small(net, **kw):
        kw.update(num_images=4, num_steps=2)
        return real(net, **kw)

    monkeypatch.setattr(api, "get_metrics", small)


def test_metrics_tick_writes_logs(nets, train_data, tmp_path, monkeypatch):
    """The trainer's metrics tick at 24 nimg (step 2 of 3): `Metrics:` in
    log.txt, `Metrics/<name>` in the next row of stats.jsonl, a row in
    metrics.jsonl."""
    _tick_get_metrics(monkeypatch)
    _trainer(tmp_path, train_data, nets["tree"])
    log = open(tmp_path / "log.txt").read()
    assert log.count("Metrics: {") == 1
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert len(rows) == 1 and rows[0]["nimg"] == 24
    assert sorted(k for k in rows[0] if k not in ("nimg", "timestamp")) == ["psnr", "stub_fid"]
    assert all(np.isfinite(rows[0][k]) for k in ("psnr", "stub_fid"))
    status = [json.loads(line) for line in open(tmp_path / "stats.jsonl")]
    assert [r["Progress/kimg"] for r in status] == [0.0, 0.012, 0.024, 0.036]
    assert "Metrics/stub_fid" not in status[2]
    assert status[3]["Metrics/stub_fid"] == pytest.approx(rows[0]["stub_fid"])
    assert status[3]["Metrics/psnr"] == pytest.approx(rows[0]["psnr"])


def test_metrics_tick_on_rank_without_results(nets, train_data, tmp_path, monkeypatch):
    """At rank 1, get_metrics returns None: the tick neither raises nor
    prints, reports or writes anything."""
    _tick_get_metrics(monkeypatch)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    calls = []
    from vivid_tpu_torch.metrics import api
    inner = api.get_metrics
    monkeypatch.setattr(api, "get_metrics", lambda net, **kw: calls.append(1) or inner(net, **kw))
    _trainer(tmp_path, train_data, nets["tree"])
    assert calls == [1]
    assert "Metrics" not in open(tmp_path / "log.txt").read()
    assert not os.path.exists(tmp_path / "metrics.jsonl")
    assert not os.path.exists(tmp_path / "stats.jsonl")


def test_metrics_need_a_test_tree(train_data, tmp_path):
    with pytest.raises(ValueError, match="test_dataset_path"):
        _trainer(tmp_path, train_data, None)


def test_cli_metrics_flags_match_the_jax_package():
    from vivid_tpu.cli import train_nvs as jcli
    from vivid_tpu_torch.cli import train_nvs
    for extra in ({}, {"metrics": 4096, "metrics_list": "fid,psnr"}):
        ours = train_nvs.setup_training_config(data="scenes/", **extra)
        theirs = jcli.setup_training_config(data="scenes/", **extra)
        for key in ("metrics_nimg", "metrics_list"):
            assert ours[key] == theirs[key], key
