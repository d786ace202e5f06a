"""The port's 256px super-resolution sampling path against vivid_tpu (CPU,
tiny): the 'sr' denoiser, the conditioning resizes, the collates' SR fields,
SR snapshots in both directions, and the base -> SR cascade and the SR-only
mode end to end on the same noise. torch cannot reproduce JAX's random bits,
so the noise on the conditioning image is drawn on the JAX side and handed
to the port."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vivid_tpu.data import collate as jcollate
from vivid_tpu.data import scenes as jscenes
from vivid_tpu.data.encoders import StandardRGBEncoder as JEncoder
from vivid_tpu.diffusion import loss as jloss
from vivid_tpu.diffusion import sampler as jsampler
from vivid_tpu.metrics.resize_jax import resize_bilinear_aa
from vivid_tpu.nn import precond as jprecond
from vivid_tpu.train import snapshots as jsnapshots
from vivid_tpu_torch import generate
from vivid_tpu_torch.compat.from_jax import from_jax
from vivid_tpu_torch.data import collate, scenes
from vivid_tpu_torch.data.encoders import StandardRGBEncoder
from vivid_tpu_torch.diffusion import sampler
from vivid_tpu_torch.diffusion.loss import down_up_resize
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.nn.unet import attention_feature_spec
from vivid_tpu_torch.train import snapshots

torch.set_num_threads(1)

RTOL = 1e-4  # fp32 on both sides; sums run in another order
TINY = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1,
            attn_resolutions=(8,), channels_per_head=8, use_bf16=False,
            remat=False)
# The shipped SR model's shape in small: one source, 20/20 labels, extra_attn.
SR = dict(TINY, model_channels=32, img_resolution=32, super_res=True, num_sources=1,
          source_label_dim=20, target_label_dim=20, extra_attn=1)


def _params(cfg, seed):
    """Numpy-seeded JAX tree; small out_gain keeps D_x near the data range."""
    rng = np.random.RandomState(seed)

    def leaf(name, shape):
        if name == "out_gain":
            return rng.uniform(0.1, 0.3, shape)
        if name.endswith("gain"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.randn(*shape)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v.shape).astype(np.float32)
                for k, v in node.items()}
    return walk(jax.eval_shape(lambda k: jprecond.precond_init(k, cfg), jax.random.PRNGKey(0)))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
    assert err <= rtol, f"relative L2 {err:.3e} > {rtol}"


def _cond_noise(rng, shape):
    """The unit noise precond_apply adds to the conditioning image for `rng`."""
    return np.array(jax.random.normal(jax.random.split(rng)[1], shape, jnp.float32))


@pytest.mark.parametrize("noisy_sr", [0.0, 0.25])
def test_sr_precond_matches_jax(noisy_sr):
    jcfg = jprecond.PrecondConfig(noisy_sr=noisy_sr, **SR)
    assert jcfg.unet_cfg.kind == "sr"
    params = _params(jcfg, 2)
    assert params["unet"]["enc/32x32_conv"]["w"].shape == (3, 3, 7, 32)   # 2*3 + 1 wide
    rng = np.random.RandomState(2)
    src = rng.randn(2, 1, 32, 32, 3).astype(np.float32)
    dst = rng.randn(2, 32, 32, 3).astype(np.float32)
    cond = rng.randn(2, 32, 32, 3).astype(np.float32)
    sigma = np.array([0.3, 2.5], np.float32)
    geo = rng.randn(2, 1, 20).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want, want_lv = jax.jit(lambda p, *a: jprecond.precond_apply(
        p, jcfg, *a[:4], conditioning_image=a[4], return_logvar=True, rng=key))(
            params, src, dst, sigma, geo, cond)
    net = NVPrecond(PrecondConfig(**dataclasses.asdict(jcfg)))
    net.load_state_dict(from_jax(params), strict=True)
    net.eval()
    # The 'sr' denoiser has 32 channels a head whatever the config asks for.
    assert {m.cfg.channels_per_head for m in net.unet.modules() if hasattr(m, "attn_qkv")} == {32}
    noise = torch.from_numpy(_cond_noise(key, cond.shape)) if noisy_sr else None
    args = [torch.from_numpy(a) for a in (src, dst, sigma, geo)]
    with torch.no_grad():
        got, got_lv = net(*args, return_logvar=True,
                          conditioning_image=torch.from_numpy(cond), cond_noise=noise)
        _close(got.numpy(), want)
        _close(got_lv.numpy(), want_lv)
        if noisy_sr:
            # The noise is part of the function: without it D_x moves.
            other = net(*args, conditioning_image=torch.from_numpy(cond),
                        cond_noise=torch.zeros_like(noise))
            assert np.linalg.norm(other.numpy() - want) > 100 * RTOL * np.linalg.norm(want)
            with pytest.raises(ValueError, match="requires cond_noise"):
                net(*args, conditioning_image=torch.from_numpy(cond),
                    generator=torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="requires conditioning_image"):
            net(*args)


def test_sr_full_width_parameter_count():
    """vivid-sr as its preset builds it: 57,549,187 trainable values plus the
    1,728 of the widened first conv, and 512 Fourier features (buffers here,
    leaves of the JAX tree); attention at S = 16384, 4096 and 1024."""
    jcfg = jprecond.PrecondConfig(
        img_resolution=256, super_res=True, num_sources=1, model_channels=64, extra_attn=1,
        source_label_dim=20, target_label_dim=20, noisy_sr=0.25)
    shapes = jax.eval_shape(lambda k: jprecond.precond_init(k, jcfg), jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    cfg = PrecondConfig(**dataclasses.asdict(jcfg))
    net = NVPrecond(cfg, device="meta")
    got = sum(t.numel() for t in net.state_dict().values())
    assert got == want == 57_550_915 + 512
    assert sum(p.numel() for p in net.parameters()) == 57_550_915
    sites = [(res * res, ch // 32) for _, ch, res in attention_feature_spec(cfg.unet_cfg)]
    assert sites == [(16384, 4), (4096, 6), (1024, 8), (1024, 8), (1024, 8),
                     (4096, 6), (16384, 4)]


@pytest.mark.parametrize("shape,factor", [((2, 32, 32, 3), 4), ((1, 64, 64, 3), 4),
                                          ((1, 24, 24, 2), 2)])
def test_down_up_resize_matches_jax(shape, factor):
    """F.interpolate's antialiased bilinear down and bilinear up against the
    JAX package's matrix form of torchvision's resize (fp32, 1e-5 absolute)."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jloss.down_up_resize(jnp.asarray(x), factor))
    got = down_up_resize(torch.from_numpy(x), factor)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    low = resize_bilinear_aa(jnp.asarray(x), shape[1] // factor, shape[2] // factor)
    t_low = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=1 / factor,
                          mode="bilinear", antialias=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(t_low.numpy(), np.asarray(low), atol=1e-5, rtol=0)


@pytest.mark.parametrize("lo,hi", [(16, 32), (64, 256)])
def test_cascade_upsample_matches_jax_image_resize(lo, hi):
    """The cascade's upsample, channel-last in and out: half-pixel bilinear
    without antialiasing, as jax.image.resize does an upscale."""
    x = np.random.RandomState(1).randn(2, lo, lo, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, hi, hi, 3), method="bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(hi, hi),
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A 32px scene dir (intrinsics scaled so that the geometry codec gives
    values near unit scale) and JAX-written tiny snapshots: a dual-source
    16px base, the unconditional model it is steered by, and a single-source
    32px SR model."""
    root = tmp_path_factory.mktemp("torch_sr")
    data = str(root / "scenes")
    os.makedirs(data)
    rng = np.random.RandomState(0)
    for i in range(3):
        scene = jscenes.synthesize_scene(rng, num_views=5, imsize=32)
        scene["fxfycxcy"] = scene["fxfycxcy"] * (16 / 64)
        jscenes.save_scene(os.path.join(data, f"scene_{i:05d}.npz"), **scene)
    cfgs = dict(base=jprecond.PrecondConfig(img_resolution=16, **TINY),
                uncond=jprecond.PrecondConfig(img_resolution=16, uncond=True, **TINY),
                sr=jprecond.PrecondConfig(noisy_sr=0.25, **SR))
    paths = {}
    for seed, (name, cfg) in enumerate(cfgs.items()):
        paths[name] = str(root / f"{name}.pkl")
        jsnapshots.save_snapshot(paths[name], _params(cfg, seed), cfg)
    return dict(root=root, data=data, **paths)


@pytest.mark.parametrize("kind", ["vanilla", "dual"])
def test_collate_sr_rows_match_jax(env, kind):
    """Same seed, same scenes -> the same rows, SR fields included."""
    name = "VanillaCollate" if kind == "vanilla" else "DualSourceCollate"
    ours = getattr(collate, name)(imsize=16, sr_size=32, seed=7)
    ref = getattr(jcollate, name)(imsize=16, sr_size=32, seed=7)
    assert ours.nimg_mult == ref.nimg_mult
    n_src = 1 if kind == "vanilla" else 2
    for scene_t, scene_j in zip(scenes.SceneDataset(env["data"], seed=1),
                                [s for s, _ in zip(jscenes.SceneDataset(env["data"], seed=1),
                                                   range(6))]):
        assert ours.sample_plan(scene_t) == ref.sample_plan(scene_j)
        rows_t, rows_j = ours.rows_from_scene(scene_t), ref.rows_from_scene(scene_j)
        assert len(rows_t) == len(rows_j) == 1
        assert sorted(rows_t[0]) == sorted(rows_j[0])
        assert rows_t[0]["sr_src_image"].shape == (n_src, 32, 32, 3)
        assert rows_t[0]["sr_geometry"].shape == (n_src, 20)
        for k in rows_j[0]:
            np.testing.assert_allclose(rows_t[0][k], rows_j[0][k], atol=1e-4, err_msg=k)


def test_sr_snapshots_load_across_packages(env, tmp_path):
    loaded = snapshots.load_snapshot(env["sr"])
    ref = jsnapshots.load_snapshot(env["sr"])
    assert dataclasses.asdict(loaded.cfg) == dataclasses.asdict(ref.cfg)
    assert loaded.net.unet.enc["32x32_conv"].weight.shape == (32, 7, 3, 3)
    path = str(tmp_path / "port_sr.pkl")
    snapshots.save_snapshot(path, loaded.net)
    back = jsnapshots.load_snapshot(path)
    assert back.cfg == ref.cfg
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(back.params)[0],
                                jax.tree_util.tree_flatten_with_path(ref.params)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(pa))


def test_make_denoiser_draws_the_conditioning_noise_once(env):
    """One draw per sampling run: every evaluation sees the same noisy
    conditioning image, and another generator seed gives another."""
    sr = snapshots.load_snapshot(env["sr"]).net
    rng = np.random.RandomState(4)
    src = torch.from_numpy(rng.randn(1, 1, 32, 32, 3).astype(np.float32))
    geo = torch.from_numpy(rng.randn(1, 1, 20).astype(np.float32))
    cond = torch.from_numpy(rng.randn(1, 32, 32, 3).astype(np.float32))
    x = torch.from_numpy(rng.randn(1, 32, 32, 3).astype(np.float32))
    t = torch.ones(1)

    def denoiser(seed):
        return sampler.make_denoiser(sr, src, geo, conditioning_image=cond,
                                     generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        den = denoiser(0)
        first = den(x, t)
        assert torch.equal(first, den(x, t))
        assert torch.equal(first, denoiser(0)(x, t))
        assert not torch.equal(first, denoiser(1)(x, t))
    with pytest.raises(ValueError, match="generator or cond_noise"):
        sampler.make_denoiser(sr, src, geo, conditioning_image=cond)


def test_cascade_and_sr_only_match_jax(env):
    """JAX-written snapshots, one collated batch, the same noise through
    both packages: guided base sampling, the bilinear upsample, SR sampling
    on it (the cascade), and the SR model alone on the down-up-resized
    target. Decoded uint8 within 1."""
    loader = jcollate.BatchLoader(iter(jscenes.SceneDataset(env["data"], seed=0)),
                                  jcollate.DualSourceCollate(imsize=16, sr_size=32, seed=0),
                                  batch_size=2, num_threads=1)
    raw = next(loader)
    loader.close()
    rng = np.random.RandomState(9)
    noise = rng.randn(2, 16, 16, 3).astype(np.float32)
    sr_noise = rng.randn(2, 32, 32, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    cond_noise = _cond_noise(key, (2, 32, 32, 3))
    jnet, jgnet, jsr = (jsnapshots.load_snapshot(env[k]) for k in ("base", "uncond", "sr"))
    jenc, enc = JEncoder(), StandardRGBEncoder()
    # The SR model has one source: the first view and its geometry.
    sr_src, sr_geo = raw["sr_src_image"][:, :1], raw["sr_geometry"][:, :1]

    @jax.jit
    def run(params, gparams, sparams, src, geo, sr_src, sr_geo, sr_tgt, noise, sr_noise):
        den = jsampler.make_denoiser(params, jnet.cfg, src=src, geometry=geo)
        gden = jsampler.make_denoiser(gparams, jgnet.cfg)
        low = jsampler.edm_sampler(den, noise, gnet_denoise=gden, num_steps=3, guidance=1.5)
        up = jax.image.resize(low, (2, 32, 32, 3), method="bilinear")
        sden = jsampler.make_denoiser(sparams, jsr.cfg, src=sr_src, geometry=sr_geo,
                                      conditioning_image=up, rng=key)
        cascade = jsampler.edm_sampler(sden, sr_noise, num_steps=3, rng=key)
        oden = jsampler.make_denoiser(sparams, jsr.cfg, src=sr_src, geometry=sr_geo,
                                      conditioning_image=jloss.down_up_resize(sr_tgt, 4), rng=key)
        return cascade, jsampler.edm_sampler(oden, sr_noise, num_steps=3, rng=key)

    want = [np.asarray(jenc.decode(x)) for x in run(
        jnet.params, jgnet.params, jsr.params, jenc.encode_latents(raw["src_image"]),
        raw["geometry"], jenc.encode_latents(sr_src), sr_geo,
        jenc.encode_latents(raw["sr_tgt_image"]), noise, sr_noise)]

    net, gnet, sr = (snapshots.load_snapshot(env[k]).net for k in ("base", "uncond", "sr"))
    tn = torch.from_numpy
    low = sampler.edm_sampler(
        sampler.make_denoiser(net, enc.encode_latents(raw["src_image"]), tn(raw["geometry"])),
        tn(noise), gnet_denoise=sampler.make_denoiser(gnet), num_steps=3, guidance=1.5)
    up = F.interpolate(low.permute(0, 3, 1, 2), size=(32, 32), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1)
    got = []
    for cond in (up, down_up_resize(enc.encode_latents(raw["sr_tgt_image"]), 4)):
        den = sampler.make_denoiser(sr, enc.encode_latents(sr_src), tn(sr_geo),
                                    conditioning_image=cond, cond_noise=tn(cond_noise))
        got.append(enc.decode(sampler.edm_sampler(den, tn(sr_noise), num_steps=3)))
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape == (2, 32, 32, 3)
        assert np.abs(g.astype(np.int16) - w.astype(np.int16)).max() <= 1
    assert np.abs(want[0].astype(np.int16) - want[1].astype(np.int16)).max() > 1


@pytest.mark.parametrize("mode", ["cascade", "sr_only", "vanilla"])
def test_generate_modes(env, tmp_path, mode):
    """generate_images_nvs end to end on the CPU: the cascade writes the SR
    model's images and SR-size views, the SR-only mode samples a super_res
    model alone, the vanilla mode feeds a single-source model. A second run
    reproduces the first (the conditioning noise comes from a generator
    seeded per batch)."""
    if mode == "cascade":
        call, res = dict(net=env["base"], gnet=env["uncond"], guidance=1.5,
                         sr_model=env["sr"]), 32
    elif mode == "sr_only":
        call, res = dict(net=env["sr"], vanilla_mode=True), 32
    else:
        cfg = jprecond.PrecondConfig(img_resolution=16, num_sources=1, source_label_dim=20,
                                     target_label_dim=20, **TINY)
        path = str(tmp_path / "vanilla.pkl")
        jsnapshots.save_snapshot(path, _params(cfg, 6), cfg)
        call, res = dict(net=path, vanilla_mode=True), 16
    call.update(seeds=range(0, 3), max_batch_size=2, num_steps=2, verbose=False, device="cpu",
                datakwargs={"path": env["data"]})
    batches = list(generate.generate_images_nvs(outdir=str(tmp_path / "out"), **call))
    assert [len(b.seeds) for b in batches] == [2, 1]
    for b in batches:
        n = len(b.seeds)
        assert b.images.dtype == np.uint8 and b.images.shape == (n, res, res, 3)
        assert b.src.shape == b.tgt.shape == (n, res, res, 3)
        assert b.latents.shape == (n, res, res, 3) and bool(torch.isfinite(b.latents).all())
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        f"{p}_{s:06d}.png" for p in ("src", "tgt", "sample") for s in range(3))
    for a, b in zip(batches, generate.generate_images_nvs(**call)):
        np.testing.assert_array_equal(a.images, b.images)


def test_generate_refuses_what_it_cannot_do(env, monkeypatch):
    kw = dict(datakwargs={"path": env["data"]}, verbose=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        generate.generate_images_nvs(net=env["base"], **kw)
    # depth_model raised until depth conditioning was ported; now an unknown
    # name is refused by name.
    with pytest.raises(ValueError, match="Unknown depth model 'd.pkl'"):
        generate.generate_images_nvs(net=env["base"], depth_model="d.pkl", device="cpu", **kw)
    # tp raised until tensor parallelism was ported; now it needs a process
    # group to split the model over, and one process is refused by name.
    with pytest.raises(ValueError, match="tp=2"):
        generate.generate_images_nvs(net=env["base"], tp=2, device="cpu", **kw)
