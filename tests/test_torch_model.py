"""The PyTorch port's Block / UNet / NVPrecond against the JAX package, on
the same weights (carried over by vivid_tpu_torch.compat.from_jax) and the
same numpy inputs, at tiny widths on the CPU (fp32)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vivid_tpu.compat.torch_export import tree_to_torch_state
from vivid_tpu.nn import blocks as jblocks
from vivid_tpu.nn import precond as jprecond
from vivid_tpu.nn import unet as junet
from vivid_tpu_torch.compat.from_jax import from_jax, to_jax
from vivid_tpu_torch.nn.blocks import Block, BlockConfig
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.nn.unet import UNet, UNetConfig, attention_feature_spec

torch.set_num_threads(1)

RTOL = 1e-4  # fp32 on both sides; sums run in another order
TINY = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1,
            attn_resolutions=(8,), channels_per_head=8, use_bf16=False,
            remat=False)


def _params(init, seed):
    """The JAX parameter tree of `init(key)` filled from a numpy seed (eager
    JAX init is slow on the CPU). Weights ~ N(0, 1); gains in [0.5, 1.5],
    not the zeros of a fresh init, so the comparison sees the emb and out
    paths; Fourier features as MPFourier draws them."""
    rng = np.random.RandomState(seed)

    def leaf(name, shape):
        if name.endswith("gain"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "phases":
            return (2 * np.pi * rng.rand(*shape)).astype(np.float32)
        scale = 2 * np.pi if name == "freqs" else 1.0
        return (scale * rng.randn(*shape)).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v.shape)
                for k, v in node.items()}
    return walk(jax.eval_shape(init, jax.random.PRNGKey(0)))


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
    assert err <= rtol, f"relative L2 {err:.3e} > {rtol}"


def _load(module, params):
    module.load_state_dict(from_jax(params), strict=True)
    return module.eval()


@pytest.mark.parametrize("kw", [
    dict(flavor="enc", resample_mode="keep", attention=True),
    dict(flavor="enc", resample_mode="down", in_channels=16),
    dict(flavor="dec", resample_mode="up", in_channels=24, attention=True),
    dict(flavor="dec", attention=True, xattn=True, in_channels=48),
    dict(flavor="dec", attention=True, xattn=True, features="zeros"),
])
def test_block_matches_jax(kw):
    kw = dict(kw)
    feats_mode = kw.pop("features", None)
    cin = kw.pop("in_channels", 32)
    jcfg = jblocks.BlockConfig(in_channels=cin, out_channels=32, emb_channels=20,
                               channels_per_head=8, **kw)
    tcfg = BlockConfig(in_channels=cin, out_channels=32, emb_channels=20,
                       channels_per_head=8, **kw)
    params = _params(lambda k: jblocks.block_init(k, jcfg), 3)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, cin).astype(np.float32)
    emb = rng.randn(2, 20).astype(np.float32)
    hw = 4 if kw.get("resample_mode") == "down" else (16 if kw.get("resample_mode") == "up" else 8)
    feats = None
    if kw.get("xattn"):
        feats = feats_mode or [rng.randn(2, hw, hw, 32).astype(np.float32) for _ in range(2)]
    if isinstance(feats, str):
        fn = lambda p, x, e, f: jblocks.block_apply(p, jcfg, x, e, features=feats)
    else:
        fn = lambda p, x, e, f: jblocks.block_apply(p, jcfg, x, e, features=f)
    want = jax.jit(fn)(params, x, emb, None if isinstance(feats, str) else feats)
    block = _load(Block(tcfg), params)
    tfeats = feats if isinstance(feats, str) or feats is None else [torch.from_numpy(f) for f in feats]
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(emb), tfeats)
    _close(got.numpy(), want)


@pytest.mark.parametrize("kind", ["xattn", "encoder"])
def test_unet_matches_jax(kind):
    common = dict(img_resolution=16, img_channels=3, label_dim=40, kind=kind,
                  model_channels=16, channel_mult=(1, 2), num_blocks=2,
                  attn_resolutions=(8,), extra_attn=1, channels_per_head=8)
    jcfg = junet.UNetConfig(remat=False, **common)
    tcfg = UNetConfig(**common)
    params = _params(lambda k: junet.unet_init(k, jcfg), 1)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    noise = rng.randn(2).astype(np.float32)
    geo = rng.randn(2, 40).astype(np.float32)
    feats = None
    if kind == "xattn":
        feats = [rng.randn(2, 2, r, r, c).astype(np.float32)
                 for _, c, r in attention_feature_spec(tcfg)]
    want = jax.jit(lambda p, *a, features: junet.unet_apply(p, jcfg, *a, features=features))(
        params, x, noise, geo, features=feats)
    net = _load(UNet(tcfg), params)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(geo),
                  features=None if feats is None else [torch.from_numpy(f) for f in feats])
    if kind == "encoder":
        assert len(got) == len(want) == len(attention_feature_spec(tcfg))
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    else:
        _close(got.numpy(), want)


@pytest.mark.parametrize("uncond", [False, True])
def test_precond_matches_jax(uncond):
    jcfg = jprecond.PrecondConfig(img_resolution=16, uncond=uncond, extra_attn=1, **TINY)
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 2)
    rng = np.random.RandomState(2)
    src = rng.randn(2, 2, 16, 16, 3).astype(np.float32)
    dst = rng.randn(2, 16, 16, 3).astype(np.float32)
    sigma = np.array([0.3, 2.5], np.float32)
    geo = rng.randn(2, 2, 20).astype(np.float32)
    want, want_lv = jax.jit(lambda p, *a: jprecond.precond_apply(
        p, jcfg, *a, return_logvar=True))(params, src, dst, sigma, geo)
    net = _load(NVPrecond(PrecondConfig(**dataclasses.asdict(jcfg))), params)
    with torch.no_grad():
        got, got_lv = net(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(sigma), torch.from_numpy(geo),
                          return_logvar=True)
    _close(got.numpy(), want)
    _close(got_lv.numpy(), want_lv)


@pytest.mark.parametrize("uncond", [False, True])
def test_precond_bf16_matches_jax(uncond):
    """The bf16 path (x_in cast to bf16, weights cast to the compute dtype,
    norms in fp32, D_x back in fp32) against the JAX package's. The two
    backends round differently inside (XLA fuses bf16 elementwise chains
    in fp32; the SiLU and attention composites differ), so the tolerance is
    set from bf16 rounding itself: r = |JAX bf16 - JAX fp32|. The port's
    bf16 output must lie within 2r of JAX's, and its own bf16 path must move
    D_x by as much as JAX's does (0.5r to 2r): a compute path left in fp32
    or rounded twice as often shows there."""
    jcfg = jprecond.PrecondConfig(img_resolution=16, uncond=uncond, extra_attn=1,
                                  **dict(TINY, use_bf16=True))
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 2)
    rng = np.random.RandomState(2)
    args = (rng.randn(2, 2, 16, 16, 3).astype(np.float32),
            rng.randn(2, 16, 16, 3).astype(np.float32),
            np.array([0.3, 2.5], np.float32),
            rng.randn(2, 2, 20).astype(np.float32))
    want, got = {}, {}
    for bf16 in (True, False):
        cfg = dataclasses.replace(jcfg, use_bf16=bf16)
        want[bf16] = np.asarray(jax.jit(lambda p, *a: jprecond.precond_apply(p, cfg, *a))(
            params, *args))
        net = _load(NVPrecond(PrecondConfig(**dataclasses.asdict(cfg))), params)
        with torch.no_grad():
            out = net(*(torch.from_numpy(a) for a in args))
        assert out.dtype == torch.float32
        got[bf16] = out.numpy()

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.linalg.norm(a - b) / np.linalg.norm(b)
    r = rel(want[True], want[False])
    assert r > 1e-3, "the JAX bf16 path should differ from fp32 by bf16 rounding"
    assert rel(got[True], want[True]) <= 2 * r
    assert 0.5 * r <= rel(got[True], got[False]) <= 2 * r


def test_from_jax_matches_torch_export_and_round_trips():
    cfg = jprecond.PrecondConfig(img_resolution=16, extra_attn=1, **TINY)
    params = _params(lambda k: jprecond.precond_init(k, cfg), 4)
    ours = from_jax(params)
    ref = tree_to_torch_state(params)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    net = NVPrecond(PrecondConfig(**dataclasses.asdict(cfg)))
    net.load_state_dict(ours, strict=True)
    back = to_jax(net.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("uncond", [False, True])
def test_full_width_parameter_counts(uncond):
    """vivid-base / vivid-uncond at full width (ch=128, extra_attn=1):
    250,654,019 and 131,265,061 values, Fourier buffers included."""
    jcfg = jprecond.PrecondConfig(img_resolution=64, num_sources=2, model_channels=128,
                                  extra_attn=1, uncond=uncond)
    shapes = jax.eval_shape(lambda k: jprecond.precond_init(k, jcfg), jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    net = NVPrecond(PrecondConfig(**dataclasses.asdict(jcfg)), device="meta")
    got = sum(t.numel() for t in net.state_dict().values())
    assert got == want
    assert round(got / 1e6, 2) == (131.27 if uncond else 250.65)


def test_seeded_init_is_deterministic_and_reference_layout():
    cfg = PrecondConfig(img_resolution=16, **TINY)
    a = NVPrecond(cfg, seed=7).state_dict()
    b = NVPrecond(cfg, seed=7).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["unet.out_gain"].item() == 0.0
    # attn_qkv stores reference (head, d, part) order as a 1x1 conv OIHW.
    assert a["unet.dec.8x8_in0.attn_qkv.weight"].shape == (96, 32, 1, 1)


def test_unported_options_raise():
    """The depth flags raised until depth conditioning was ported: each now
    builds the JAX package's input widths; the two together are refused
    (tests/test_torch_depth.py holds their forwards to JAX's)."""
    for flag, enc_cin, unet_cin in (("warp_depth_coor", 131, 131), ("depth_input", 4, 3)):
        net = NVPrecond(PrecondConfig(img_resolution=16, **{flag: True}, **TINY), device="meta")
        jcfg = jprecond.PrecondConfig(img_resolution=16, **{flag: True}, **TINY)
        assert net.encoder.cfg.img_channels == jcfg.encoder_cfg.img_channels == enc_cin
        assert net.unet.cfg.img_channels == jcfg.unet_cfg.img_channels == unet_cin
    with pytest.raises(ValueError, match="depth_input and PrecondConfig.warp_depth_coor"):
        NVPrecond(PrecondConfig(img_resolution=16, depth_input=True, warp_depth_coor=True,
                                **TINY), device="meta")


def test_epipolar_geometry_matches_jax():
    from vivid_tpu.geometry import epipolar as jepi
    from vivid_tpu_torch.geometry import epipolar
    rng = np.random.RandomState(0)
    geo = (0.3 * rng.randn(3, 20)).astype(np.float32)
    for imsize, patch in ((16, 2), (64, 8)):
        want = np.asarray(jepi.get_epipolar_dist(geo, imsize, patch))
        got = epipolar.get_epipolar_dist(torch.from_numpy(geo), imsize, patch)
        n = (imsize // patch) ** 2
        assert got.is_contiguous() and got.shape == want.shape == (3, n, n)
        # Distances reach the image size; the projection divides by a depth.
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3 * imsize)
    mixing = rng.randn(4, 5).astype(np.float32)
    want = np.asarray(jepi.get_epipolar_attn(want, mixing, patch_size=8))
    got = epipolar.get_epipolar_attn(got, torch.from_numpy(mixing), patch_size=8)
    assert got.shape == want.shape == (3, 5, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-3)


def test_precond_with_epipolar_bias_matches_jax():
    """The learned epipolar bias rides into the cross segments of the packed
    attention; epipolar_mixing is random here (a fresh init has it at 0)."""
    jcfg = jprecond.PrecondConfig(img_resolution=16, extra_attn=1,
                                  epipolar_attention_bias=True, **TINY)
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 8)
    assert "epipolar_mixing" in params["unet"]["dec/8x8_in0"]
    rng = np.random.RandomState(8)
    args = (rng.randn(2, 2, 16, 16, 3).astype(np.float32),
            rng.randn(2, 16, 16, 3).astype(np.float32),
            np.array([0.3, 2.5], np.float32),
            (0.3 * rng.randn(2, 2, 20)).astype(np.float32))
    want = jax.jit(lambda p, *a: jprecond.precond_apply(p, jcfg, *a))(params, *args)
    net = _load(NVPrecond(PrecondConfig(**dataclasses.asdict(jcfg))), params)
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in args))
    _close(got.numpy(), want)
    off = _load(NVPrecond(PrecondConfig(**dataclasses.asdict(jcfg))), params)
    with torch.no_grad():
        for name, p in off.named_parameters():
            if name.endswith("epipolar_mixing"):
                p.zero_()
        assert _rel(off(*(torch.from_numpy(a) for a in args)).numpy(), want) > 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)
