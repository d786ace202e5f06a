"""The port's library pieces against vivid_tpu on the CPU: the geometry
codec and the homography warp on tensors, the native library's probes, the
registry and the URL / cache helpers. Inputs are seeded numpy arrays; fp32
results agree to rtol 1e-5, 1e-4 where a matrix inverse is involved."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.core import registry as jregistry, util as jutil
from vivid_tpu.geometry import codec as jcodec, warp as jwarp
from vivid_tpu.native import fast_image as jfast_image
from vivid_tpu_torch.core import registry, util
from vivid_tpu_torch.geometry import codec, warp
from vivid_tpu_torch.native import fast_image

RTOL, RTOL_INV = 1e-5, 1e-4


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _pose(rng, lead=()):
    """Random rotations (small angles) with translations, [..., 3, 4]."""
    out = np.zeros(lead + (3, 4), np.float32)
    for idx in np.ndindex(*lead):
        a = rng.randn(3) * 0.1
        R = np.asarray(warp.euler_to_rotation_matrix(*a))
        out[idx] = np.concatenate([R, rng.randn(3, 1) * 0.3], 1)
    return out


def _intrinsics(rng, lead=()):
    f = 50 + rng.uniform(0, 20, lead + (2,))
    c = 32 + rng.uniform(-2, 2, lead + (2,))
    return np.concatenate([f, c], -1).astype(np.float32)


def test_compose_and_decompose_K_match_jax():
    rng = np.random.RandomState(0)
    vec = _intrinsics(rng, (3, 2))
    K = codec.decompose_K(torch.from_numpy(vec))
    _close(K, jcodec.decompose_K(jnp.asarray(vec)))
    _close(codec.compose_K(K), jcodec.compose_K(jnp.asarray(np.asarray(K))))
    _close(codec.compose_K(K), vec)


@pytest.mark.parametrize("imsize", [64, 256])
def test_compose_and_decompose_geometry_match_jax(imsize):
    rng = np.random.RandomState(1)
    pose, src_K, tgt_K = _pose(rng, (4,)), _intrinsics(rng, (4,)), _intrinsics(rng, (4,))
    got = codec.compose_geometry(torch.from_numpy(pose), torch.from_numpy(src_K),
                                 torch.from_numpy(tgt_K), imsize)
    want = jcodec.compose_geometry(jnp.asarray(pose), src_K, tgt_K, imsize)
    _close(got, want)
    _close(got, codec.compose_geometry_np(pose, src_K, tgt_K, imsize))
    for g, w in zip(codec.decompose_geometry(got, imsize),
                    jcodec.decompose_geometry(jnp.asarray(np.asarray(got)), imsize)):
        _close(g, w, atol=1e-4)


def test_resize_geometry_matches_jax():
    rng = np.random.RandomState(2)
    g = codec.compose_geometry_np(_pose(rng, (3,)), _intrinsics(rng, (3,)),
                                  _intrinsics(rng, (3,)), 64)
    got = codec.resize_geometry(torch.from_numpy(g), 64, 256)
    _close(got, jcodec.resize_geometry(jnp.asarray(g), 64, 256), atol=1e-5)
    _close(codec.resize_geometry(got, 256, 64), g, atol=1e-4)


def test_expand_extrinsics_and_relative_pose_match_jax():
    rng = np.random.RandomState(3)
    src, tgt = _pose(rng, (2, 3)), _pose(rng, (2, 3))
    ex_src = codec.expand_extrinsics(torch.from_numpy(src))
    ex_tgt = codec.expand_extrinsics(torch.from_numpy(tgt))
    _close(ex_src, jcodec.expand_extrinsics(jnp.asarray(src)))
    want = jcodec.relative_pose(jnp.asarray(np.asarray(ex_src)), jnp.asarray(np.asarray(ex_tgt)))
    _close(codec.relative_pose(ex_src, ex_tgt), want, rtol=RTOL_INV, atol=1e-5)


def test_euler_to_rotation_matrix_matches_jax():
    rng = np.random.RandomState(4)
    for _ in range(8):
        a = (rng.uniform(-1, 1, 3) * np.pi / 8).astype(np.float32)
        R = warp.euler_to_rotation_matrix(*a)
        _close(R, jwarp.euler_to_rotation_matrix(*map(jnp.asarray, a)))
        _close(R @ R.T, np.eye(3), atol=1e-6)


def test_bilinear_sample_matches_jax():
    rng = np.random.RandomState(5)
    image = rng.uniform(0, 255, (12, 10, 3)).astype(np.float32)
    coords = rng.uniform(-2, 13, (7, 9, 2)).astype(np.float32)
    got = warp.bilinear_sample(torch.from_numpy(image), torch.from_numpy(coords))
    _close(got, jwarp.bilinear_sample(jnp.asarray(image), jnp.asarray(coords)), atol=1e-3)


@pytest.mark.parametrize("out_shape", [None, (10, 14)])
def test_warp_perspective_matches_jax(out_shape):
    rng = np.random.RandomState(6)
    image = rng.uniform(0, 255, (16, 12, 3)).astype(np.float32)
    K = np.array([[10, 0, 6], [0, 10, 8], [0, 0, 1]], np.float32)
    R = np.asarray(warp.euler_to_rotation_matrix(0.05, -0.1, 0.02))
    H = (K @ R @ np.linalg.inv(K)).astype(np.float32)
    got = warp.warp_perspective(torch.from_numpy(image), torch.from_numpy(H), out_shape)
    want = jwarp.warp_perspective(jnp.asarray(image), jnp.asarray(H), out_shape)
    assert got.shape == want.shape
    _close(got, want, rtol=RTOL_INV, atol=1e-2)
    _close(warp.inverse_3x3(torch.from_numpy(H)), np.linalg.inv(H), rtol=RTOL_INV, atol=1e-6)


def _fresh_jax_library(monkeypatch, path):
    """vivid_tpu's probes asked anew, its library built at `path`. The JAX
    package builds in place in its own directory, where a process that loads
    the library while another writes it fails, and caches the failure for its
    life (ROADMAP C-ref-12); a library of this test's own is whole."""
    monkeypatch.setattr(jfast_image, "_LIB", str(path))
    monkeypatch.setattr(jfast_image, "_lib", None)
    monkeypatch.setattr(jfast_image, "_failed", False)


def test_native_probes_match_jax(monkeypatch, tmp_path):
    _fresh_jax_library(monkeypatch, tmp_path / "libfast_image.so")
    assert fast_image.fast_resize_available() == jfast_image.fast_resize_available() is True
    assert fast_image.png_decode_available() == jfast_image.png_decode_available() is True
    monkeypatch.setenv("VIVID_NO_NATIVE", "1")
    _fresh_jax_library(monkeypatch, tmp_path / "libfast_image.so")
    assert not fast_image.fast_resize_available() and not fast_image.png_decode_available()
    assert not jfast_image.fast_resize_available() and not jfast_image.png_decode_available()


def test_register_and_call_func_by_name_match_jax():
    for mod in (registry, jregistry):
        mod.register("test_registry.scaled_sum")(lambda *xs, scale=1: scale * sum(xs))
        assert mod.call_func_by_name(1, 2, func_name="test_registry.scaled_sum", scale=3) == 9
    name = "vivid_tpu.diffusion.lr.learning_rate_schedule"
    got = registry.call_func_by_name(5_000_000, 1024, func_name=name, ref_lr=0.012)
    want = jregistry.call_func_by_name(5_000_000, 1024, func_name=name, ref_lr=0.012)
    assert math.isclose(float(got), float(want), rel_tol=1e-6)
    assert registry.get_obj_by_name(name).__module__ == "vivid_tpu_torch.diffusion.lr"

    @registry.register()
    def named_by_path():
        return 7
    assert registry.call_func_by_name(
        func_name=f"{named_by_path.__module__}.{named_by_path.__qualname__}") == 7
    with pytest.raises(TypeError, match="not callable"):
        registry.call_func_by_name(func_name="vivid_tpu_torch.kernels.flash.NORM_EPS")


def test_cache_and_urls_match_jax(tmp_path, monkeypatch):
    for s in ("https://example.com/a.pkl", "http://host/x", "file:///tmp/x", "/tmp/x",
              "ftp://host/x", 3, "https://"):
        for allow in (False, True):
            assert util.is_url(s, allow) == jutil.is_url(s, allow), (s, allow)
    monkeypatch.setenv("VIVID_CACHE_DIR", str(tmp_path / "env"))
    for mod in (util, jutil):
        mod.set_cache_dir(None)
    assert util.make_cache_dir_path("downloads") == jutil.make_cache_dir_path("downloads") \
        == str(tmp_path / "env" / "downloads")
    for mod in (util, jutil):
        mod.set_cache_dir(str(tmp_path / "set"))
    try:
        assert util.make_cache_dir_path("a", "b") == jutil.make_cache_dir_path("a", "b") \
            == str(tmp_path / "set" / "a" / "b")
        local = tmp_path / "local.bin"
        local.write_bytes(b"local")
        for url in (str(local), f"file://{local}"):
            assert util.open_url(url, return_filename=True) == jutil.open_url(
                url, return_filename=True) == str(local)
            with util.open_url(url) as f:
                assert f.read() == b"local"
        url = "https://example.com/models/vivid-base.pkl"
        errors = []
        for mod in (util, jutil):
            with pytest.raises(FileNotFoundError) as err:
                mod.open_url(url)
            errors.append(str(err.value))
        assert errors[0] == errors[1]
        cached = errors[0].split("placing the file at ")[1].split(" (or ")[0]
        with open(cached, "wb") as f:
            f.write(b"cached")
        assert util.open_url(url, return_filename=True, verbose=False) == jutil.open_url(
            url, return_filename=True, verbose=False) == cached
        with util.open_url(url, verbose=False) as f:
            assert f.read() == b"cached"
    finally:
        for mod in (util, jutil):
            mod.set_cache_dir(None)


def test_load_snapshot_resolves_urls_through_the_cache(tmp_path):
    """A --net (or --gnet, --sr-model) given as a URL resolves through
    `open_url`: from the download cache, or a FileNotFoundError naming the
    path to place the file at; a file:// URL reads the file."""
    from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
    from vivid_tpu_torch.train.snapshots import load_snapshot, save_snapshot
    cfg = PrecondConfig(img_resolution=16, model_channels=16, channel_mult=(1, 2),
                        num_blocks=1, attn_resolutions=(8,), channels_per_head=8,
                        use_bf16=False)
    net = NVPrecond(cfg, seed=0)
    url = "https://example.com/models/vivid-tiny.pkl"
    util.set_cache_dir(str(tmp_path / "cache"))
    try:
        with pytest.raises(FileNotFoundError, match="vivid-tiny.pkl"):
            load_snapshot(url)
        save_snapshot(os.path.join(util.make_cache_dir_path("downloads"), "vivid-tiny.pkl"), net)
        local = str(tmp_path / "local.pkl")
        save_snapshot(local, net)
        want = load_snapshot(local).net.state_dict()
        for path in (url, f"file://{local}"):
            got = load_snapshot(path)
            assert got.cfg == cfg
            assert all(torch.equal(got.net.state_dict()[k], v) for k, v in want.items())
    finally:
        util.set_cache_dir(None)
