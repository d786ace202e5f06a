"""The port's depth conditioning against vivid_tpu on the CPU, at tiny
sizes: the depth warp and its Fourier features, DepthAnythingV2's input
preparation and output resize (each with the form without antialiasing
shown to fail), the DepthAnythingV2 network (a 4-block ViT and the DPT head
at 56 px, with the head's resize moved off align_corners shown to fail),
the depth channel, NVPrecond with `depth_input` and with `warp_depth_coor`,
the two flags refused together (the JAX package crashes there), and depth
through sampling, the trainer and the CLI."""

import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vivid_tpu.geometry import depth as jdepth, depth_anything as jdav2, warp as jwarp
from vivid_tpu.nn import precond as jprecond
from vivid_tpu.nn.mp import mp_fourier_apply
from vivid_tpu_torch.cli import train_nvs
from vivid_tpu_torch.compat.from_jax import depth_anything_from_jax
from vivid_tpu_torch.data import collate, scenes
from vivid_tpu_torch.data.encoders import StandardRGBEncoder
from vivid_tpu_torch.geometry import depth, depth_anything, warp
from vivid_tpu_torch.nn.mp import MPFourier
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train.snapshots import save_snapshot

from test_torch_model import TINY, _close, _load, _params

torch.set_num_threads(1)

WARP_TOL = 1e-4        # max |port - JAX| of the Fourier features: phases reach
                       # hundreds of radians in fp32
PREPARE_TOL = 1e-4     # max |port - JAX| of depth_prepare's normalised pixels
RESIZE_TOL = 1e-6      # max |port - JAX| of get_depth's resize over the depth's max
DAV2_TOL = 1e-4        # relative L2 of the depth map
TINY_DAV2 = jdav2.DAV2Config(embed_dim=32, depth=4, num_heads=2, layer_idx=(0, 1, 2, 3),
                             features=16, out_channels=(8, 16, 32, 32), max_depth=20.0)
GRID = 4               # 56 px
NET = dict(TINY, img_resolution=16, extra_attn=1)


def _fourier(rng):
    freqs = (2 * np.pi * rng.randn(128)).astype(np.float32)
    phases = (2 * np.pi * rng.rand(128)).astype(np.float32)
    module = MPFourier(128)
    module.freqs.copy_(torch.from_numpy(freqs))
    module.phases.copy_(torch.from_numpy(phases))
    return partial(mp_fourier_apply, {"freqs": jnp.asarray(freqs),
                                      "phases": jnp.asarray(phases)}), module


def _depth_and_geometry(rng, b=2, h=8, w=8):
    """Positive depth and a geometry near the codec's mean (a plausible
    relative pose and intrinsics)."""
    d = (1 + rng.rand(b, h, w, 1)).astype(np.float32)
    return d, (0.1 * rng.randn(b, 20)).astype(np.float32)


def test_warp_image_matches_jax():
    rng = np.random.RandomState(0)
    d, geo = _depth_and_geometry(rng)
    coords = (8 * rng.rand(2, 8, 8, 2)).astype(np.float32)
    want = np.asarray(jwarp.warp_image(d, geo, coords))
    got = warp.warp_image(*map(torch.from_numpy, (d, geo, coords))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_warped_features_match_jax():
    rng = np.random.RandomState(1)
    d, geo = _depth_and_geometry(rng)
    jfn, module = _fourier(rng)
    want = jwarp.get_warped_features(jnp.asarray(d), jnp.asarray(geo), jfn)
    got = warp.get_warped_features(torch.from_numpy(d), torch.from_numpy(geo), module)
    for g, w in zip(got, want):
        assert g.shape == (2, 8, 8, 128)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=WARP_TOL)


def _pixels(rng, b=2, h=16, w=16):
    return rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)


def test_depth_prepare_matches_jax():
    """Up to 56 px (518 in use): bicubic with antialiasing is JAX's cubic
    resize; PyTorch's bicubic without it (Keys a = -0.75) is not."""
    x = _pixels(np.random.RandomState(2))
    want = np.asarray(jdepth.depth_prepare(x, size=56))
    got = depth.depth_prepare(torch.from_numpy(x), size=56).numpy()
    assert got.shape == want.shape == (2, 56, 56, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=PREPARE_TOL)
    plain = F.interpolate(torch.from_numpy(x / 255.0).permute(0, 3, 1, 2), size=(56, 56),
                          mode="bicubic", antialias=False).permute(0, 2, 3, 1)
    plain = ((plain - torch.tensor(depth.IMAGENET_MEAN)) / torch.tensor(depth.IMAGENET_STD))
    assert np.abs(plain.numpy() - want).max() > 10 * PREPARE_TOL


def _depth_maps(rng, b=2):
    """A depth model that ignores its input: the resize alone is compared."""
    maps = (1 + 4 * rng.rand(b, 56, 56)).astype(np.float32)
    return (lambda x: jnp.asarray(maps[: x.shape[0]]),
            lambda x: torch.from_numpy(maps[: x.shape[0]]))


def test_get_depth_matches_jax():
    """Down from the model's 56 px to 16: bilinear with antialiasing is JAX's
    resize; without it PyTorch samples 4 of every 14 pixels."""
    rng = np.random.RandomState(3)
    x = _pixels(rng)
    jmodel, tmodel = _depth_maps(rng)
    want = np.asarray(jdepth.get_depth(jmodel, x))
    got = depth.get_depth(tmodel, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL * scale)
    plain = F.interpolate(tmodel(x)[:, None], size=(16, 16), mode="bilinear",
                          antialias=False)[:, 0, ..., None]
    assert np.abs(plain.numpy() - want).max() > 10 * RESIZE_TOL * scale


@pytest.mark.parametrize("inv_norm", [False, True])
def test_add_depth_matches_jax(inv_norm):
    rng = np.random.RandomState(4)
    x = _pixels(rng)
    src = rng.randn(2, 16, 16, 3).astype(np.float32)
    jmodel, tmodel = _depth_maps(rng)
    want = np.asarray(jdepth.add_depth(jmodel, x, src, inv_norm=inv_norm))
    got = depth.add_depth(tmodel, torch.from_numpy(x), torch.from_numpy(src),
                          inv_norm=inv_norm).numpy()
    assert got.shape == (2, 16, 16, 4)
    np.testing.assert_array_equal(got[..., :3], src)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def random_checkpoint(cfg, num_tokens, seed=0):
    """An original-naming DepthAnythingV2 state dict with fan-in scaled
    weights, so that the depth map varies with the input."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, shape in jdav2.expected_state_dict_shapes(cfg, num_tokens).items():
        if len(shape) >= 2 and not name.endswith(("_token", "pos_embed")):
            fan_in = int(np.prod(shape[1:])) if "resize_layers.0" not in name \
                and "resize_layers.1" not in name else shape[0]
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name.endswith(("norm1.weight", "norm2.weight", "norm.weight")):
            v = 1 + 0.1 * rng.randn(*shape)
        elif name.endswith("gamma"):
            v = 0.5 + 0.1 * rng.randn(*shape)
        else:
            v = 0.02 * rng.randn(*shape)
        sd[name] = torch.from_numpy(v.astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def dav2():
    """The JAX tree and the port's module on the same random checkpoint,
    and a normalised 56 px input."""
    sd = random_checkpoint(TINY_DAV2, GRID * GRID + 1)
    params = jdav2.params_from_state_dict(sd, TINY_DAV2)
    model = depth_anything.DepthAnythingV2(depth_anything.DAV2Config(
        **dataclasses.asdict(TINY_DAV2)), grid=GRID)
    depth_anything.load_checkpoint(model, depth_anything_from_jax(params))
    x = np.random.RandomState(5).randn(2, GRID * 14, GRID * 14, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jdav2.dav2_apply(p, TINY_DAV2, x))(params, x))
    return dict(sd=sd, params=params, model=model.eval(), x=x, want=want)


def test_depth_anything_from_jax_is_the_original_checkpoint(dav2):
    got = depth_anything_from_jax(dav2["params"])
    assert sorted(got) == sorted(dav2["sd"])
    for k, v in dav2["sd"].items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_dav2_matches_jax(dav2, monkeypatch):
    with torch.no_grad():
        got = dav2["model"](torch.from_numpy(dav2["x"])).numpy()
    want = dav2["want"]
    assert got.shape == want.shape == (2, 56, 56)
    assert want.std() > 0.1, "the depth map should vary"
    _close(got, want, rtol=DAV2_TOL)
    # The head's resizes moved off align_corners must fail the same gate.
    monkeypatch.setattr(depth_anything, "resize_ac", lambda x, size: F.interpolate(
        x, size=tuple(size), mode="bilinear", align_corners=False))
    with torch.no_grad():
        faulty = dav2["model"](torch.from_numpy(dav2["x"])).numpy()
    with pytest.raises(AssertionError):
        _close(faulty, want, rtol=DAV2_TOL)


@pytest.mark.parametrize("size", ["small", "base", "large"])
def test_expected_state_dict_shapes_match_jax(size):
    ours = depth_anything.expected_state_dict_shapes(depth_anything.SIZES[size])
    assert ours == jdav2.expected_state_dict_shapes(jdav2.SIZES[size])
    model = depth_anything.DepthAnythingV2(depth_anything.SIZES[size], device="meta")
    shapes = {f"pretrained.{k}": tuple(v.shape) for k, v in model.pretrained.state_dict().items()}
    shapes.update({f"depth_head.{k}": tuple(v.shape)
                   for k, v in model.depth_head.state_dict().items()})
    assert shapes == ours


def test_resolve_depth_model(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "depth_anything_v2_metric_"
                                                                "hypersim_vitb.pth")):
        depth.resolve_depth_model("base", weights_dir=str(tmp_path), device="cpu")
    monkeypatch.setenv("VIVID_DEPTH_DIR", str(tmp_path / "env"))
    with pytest.raises(FileNotFoundError, match="env"):
        depth.resolve_depth_model("large", device="cpu")
    with pytest.raises(ValueError, match="Unknown depth model"):
        depth.resolve_depth_model("huge", weights_dir=str(tmp_path))
    assert depth.resolve_depth_model(None) is None
    fn = lambda x: x   # noqa: E731
    assert depth.resolve_depth_model(fn) is fn
    # A 'small' checkpoint with a tiny configuration: built, loaded, run.
    monkeypatch.setitem(depth_anything.SIZES, "small", depth_anything.DAV2Config(
        **dataclasses.asdict(TINY_DAV2)))
    torch.save(random_checkpoint(TINY_DAV2, 37 * 37 + 1),
               str(tmp_path / "depth_anything_v2_metric_hypersim_vits.pth"))
    model = depth.resolve_depth_model("small", weights_dir=str(tmp_path), device="cpu")
    assert not model.training
    with torch.no_grad():
        out = model(depth.depth_prepare(torch.from_numpy(_pixels(np.random.RandomState(6), 1))))
    assert out.shape == (1, 518, 518) and bool(torch.isfinite(out).all())
    assert float(out.min()) >= 0 and float(out.max()) <= TINY_DAV2.max_depth


@pytest.mark.parametrize("flag", ["depth_input", "warp_depth_coor"])
def test_precond_depth_flags_match_jax(flag):
    jcfg = jprecond.PrecondConfig(**NET, **{flag: True})
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 2)
    rng = np.random.RandomState(7)
    src = rng.randn(2, 2, 16, 16, 4).astype(np.float32)
    src[..., 3] = 1 + np.abs(src[..., 3])   # depth
    dst = rng.randn(2, 16, 16, 3).astype(np.float32)
    sigma = np.array([0.3, 2.5], np.float32)
    geo = (0.1 * rng.randn(2, 2, 20)).astype(np.float32)
    want, want_lv = jax.jit(lambda p, *a: jprecond.precond_apply(
        p, jcfg, *a, return_logvar=True))(params, src, dst, sigma, geo)
    cfg = PrecondConfig(**dataclasses.asdict(jcfg))
    net = _load(NVPrecond(cfg), params)
    want_cin = 3 + (1 if flag == "depth_input" else 128)
    assert net.encoder.cfg.img_channels == want_cin
    assert net.unet.cfg.img_channels == (131 if flag == "warp_depth_coor" else 3)
    with torch.no_grad():
        got, got_lv = net(*map(torch.from_numpy, (src, dst, sigma, geo)), return_logvar=True)
    _close(got.numpy(), want)
    _close(got_lv.numpy(), want_lv)
    if flag == "warp_depth_coor":
        with pytest.raises(ValueError, match="depth channel"):
            net(torch.from_numpy(src[..., :3]), *map(torch.from_numpy, (dst, sigma, geo)))


def test_both_depth_flags_refused_and_the_jax_crash_pinned():
    """The encoder would be built for rgb + depth + 128 grid channels and fed
    rgb + grid: the port refuses the pair by name; the JAX package builds
    the net and crashes in its first convolution (C-ref-7)."""
    both = dict(NET, depth_input=True, warp_depth_coor=True)
    with pytest.raises(ValueError, match="depth_input.*warp_depth_coor"):
        NVPrecond(PrecondConfig(**both), device="meta")
    jcfg = jprecond.PrecondConfig(**both)
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 2)
    rng = np.random.RandomState(8)
    src = np.abs(rng.randn(2, 2, 16, 16, 4)).astype(np.float32) + 1
    with pytest.raises(ValueError, match="132 // 1 != 133"):
        jprecond.precond_apply(params, jcfg, src, rng.randn(2, 16, 16, 3).astype(np.float32),
                               np.ones(2, np.float32),
                               (0.1 * rng.randn(2, 2, 20)).astype(np.float32))


def _depth_fns():
    """The same depth model in both frameworks: a smooth positive function
    of the prepared image."""
    return (lambda x: 1.0 + jnp.mean(x, axis=-1) ** 2), (lambda x: 1.0 + x.mean(-1) ** 2)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return scenes.make_synthetic_dataset(str(tmp_path_factory.mktemp("depth") / "scenes"),
                                         num_scenes=3, num_views=5, imsize=16)


def test_generate_with_depth_model(scene_dir, tmp_path, monkeypatch):
    """`generate_images_nvs` with a callable depth model and a depth_input
    snapshot: the sources the sampler gets are the encoded rows with the
    JAX package's add_depth channel (inverse-normalised), and it samples."""
    from vivid_tpu_torch import generate
    net = NVPrecond(PrecondConfig(**dict(NET, depth_input=True)), seed=5)
    snap = str(tmp_path / "depth.pkl")
    save_snapshot(snap, net)
    seen = []
    real = generate.make_denoiser
    monkeypatch.setattr(generate, "make_denoiser",
                        lambda net, src=None, *a, **k: seen.append(src) or real(net, src, *a, **k))
    jfn, tfn = _depth_fns()
    (batch,) = generate.generate_images_nvs(snap, seeds=range(2), max_batch_size=2,
                                            num_steps=2, depth_model=tfn, rng_seed=3,
                                            datakwargs={"path": scene_dir}, verbose=False,
                                            device="cpu")
    assert batch.images.shape == (2, 16, 16, 3) and bool(torch.isfinite(batch.latents).all())
    loader = collate.BatchLoader(iter(scenes.SceneDataset(scene_dir, seed=3)),
                                 collate.DualSourceCollate(16, seed=3), batch_size=2)
    try:
        raw = next(loader)["src_image"]
    finally:
        loader.close()
    enc = StandardRGBEncoder().encode_latents(raw).numpy().reshape(4, 16, 16, 3)
    want = np.asarray(jdepth.add_depth(jfn, raw.reshape(4, 16, 16, 3), enc, inv_norm=True))
    got = seen[0].numpy().reshape(4, 16, 16, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("flag", ["depth_input", "warp_depth_coor"])
def test_training_loop_with_depth_model(scene_dir, tmp_path, monkeypatch, flag):
    """One step with a callable depth model (tests/test_loop_extras.py's
    run), a sample grid through it, and a metrics tick that hands the depth
    model and the test split to the metrics."""
    from vivid_tpu_torch.metrics import api
    from vivid_tpu_torch.train.loop import training_loop
    seen = {}

    def fake_metrics(net, **kw):
        seen.update(kw)
        return {"psnr": 1.0}

    monkeypatch.setattr(api, "get_metrics", fake_metrics)
    tfn = _depth_fns()[1]
    run = tmp_path / "run"
    result = training_loop(
        run_dir=str(run), dataset_kwargs={"path": scene_dir}, test_dataset_path=scene_dir,
        network_kwargs=dict(NET, remat=False, **{flag: True}), depth_model=tfn,
        loss_kwargs=dict(P_mean=-0.8, P_std=1.6),
        lr_kwargs=dict(ref_lr=1e-3, ref_batches=100, rampup_Mimg=0), batch_size=2,
        eval_samples=2, status_nimg=None, samples_nimg=12, metrics_nimg=12,
        snapshot_nimg=None, checkpoint_nimg=None, max_steps=1, device="cpu")
    assert result.state.cur_nimg == 2 * 6
    assert all(torch.isfinite(p).all() for p in result.state.params)
    assert (run / "results" / "generated-samples-0000000.png").exists()
    assert seen["depth_model"] is tfn and seen["datakwargs"]["split"] == "test"
    assert json.loads((run / "metrics.jsonl").read_text().splitlines()[0])["psnr"] == 1.0


def test_cli_hands_the_depth_flags_to_the_config(capsys):
    train_nvs.cmdline(["--data", "scenes/", "--dry-run", "--depth-model", "small",
                       "--warp-depth-coor"], standalone_mode=False)
    text = capsys.readouterr().out
    cfg = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert cfg["depth_model"] == "small"
    assert cfg["network_kwargs"]["warp_depth_coor"] and not cfg["network_kwargs"]["depth_input"]
    from vivid_tpu.cli import train_nvs as jcli
    want = jcli.setup_training_config(data="scenes/", depth_model="small", depth_input=True)
    got = train_nvs.setup_training_config(data="scenes/", depth_model="small", depth_input=True)
    assert got.depth_model == want.depth_model == "small"
    for key in ("depth_input", "warp_depth_coor"):
        assert got.network_kwargs[key] == want.network_kwargs[key], key
