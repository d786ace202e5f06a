"""The port's sampling slice as a whole against vivid_tpu (CPU, tiny):
collate, snapshots in both directions, sampler + decode on one collated
batch, the PNG writer, and the port running with JAX and vivid_tpu absent."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from vivid_tpu.data import collate as jcollate
from vivid_tpu.data import scenes as jscenes
from vivid_tpu.data.encoders import StandardRGBEncoder as JEncoder
from vivid_tpu.diffusion import sampler as jsampler
from vivid_tpu.nn import precond as jprecond
from vivid_tpu.train import snapshots as jsnapshots
from vivid_tpu_torch.data import collate, scenes
from vivid_tpu_torch.data.encoders import StandardRGBEncoder
from vivid_tpu_torch.diffusion import sampler
from vivid_tpu_torch.generate import generate_images_nvs
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train import snapshots

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1,
            attn_resolutions=(8,), channels_per_head=8, use_bf16=False,
            remat=False)


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


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A 32px scene dir and JAX-written tiny base + uncond snapshots. The
    synthetic intrinsics are for 64px views: scaled to the 16px the models
    see, the geometry codec gives values near unit scale (at ~100, a
    random-weight net amplifies float rounding past any tolerance)."""
    root = tmp_path_factory.mktemp("torch_gen")
    data = str(root / "scenes")
    os.makedirs(data)
    rng = np.random.RandomState(0)
    for i in range(3):
        scene = jscenes.synthesize_scene(rng, num_views=5, imsize=32)
        scene["fxfycxcy"] = scene["fxfycxcy"] * (16 / 64)
        jscenes.save_scene(os.path.join(data, f"scene_{i:05d}.npz"), **scene)
    cfg = jprecond.PrecondConfig(img_resolution=16, **TINY)
    gcfg = jprecond.PrecondConfig(img_resolution=16, uncond=True, **TINY)
    snap, gsnap = str(root / "base.pkl"), str(root / "uncond.pkl")
    jsnapshots.save_snapshot(snap, _params(cfg, 0), cfg)
    jsnapshots.save_snapshot(gsnap, _params(gcfg, 1), gcfg)
    return dict(root=root, data=data, snap=snap, gsnap=gsnap)


def test_synthetic_scenes_match():
    a = jscenes.synthesize_scene(np.random.RandomState(3), num_views=4, imsize=16)
    b = scenes.synthesize_scene(np.random.RandomState(3), num_views=4, imsize=16)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("imsize", [32, 16])
def test_collate_matches_jax(env, imsize):
    """Same seed, same scenes -> the same rows (16 is a 2x box downscale)."""
    ours = collate.DualSourceCollate(imsize=imsize, seed=7)
    ref = jcollate.DualSourceCollate(imsize=imsize, seed=7)
    for scene_t, scene_j in zip(scenes.SceneDataset(env["data"], seed=1),
                                [s for s, _ in zip(jscenes.SceneDataset(env["data"], seed=1),
                                                   range(6))]):
        rows_t, rows_j = ours.rows_from_scene(scene_t), ref.rows_from_scene(scene_j)
        assert len(rows_t) == len(rows_j) == 1
        for k in rows_j[0]:
            np.testing.assert_allclose(rows_t[0][k], rows_j[0][k], atol=1e-4, err_msg=k)


def test_snapshots_load_across_packages(env, tmp_path):
    loaded = snapshots.load_snapshot(env["snap"])
    ref = jsnapshots.load_snapshot(env["snap"])
    assert dataclasses.asdict(loaded.cfg) == dataclasses.asdict(ref.cfg)
    path = str(tmp_path / "port.pkl")
    snapshots.save_snapshot(path, loaded.net)
    back = jsnapshots.load_snapshot(path)
    assert back.cfg == ref.cfg
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(back.params)[0],
                                jax.tree_util.tree_flatten_with_path(ref.params)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(pa))


def test_slice_matches_jax(env):
    """JAX-written snapshots, one collated batch, the same noise through both
    packages' make_denoiser + edm_sampler + decode: uint8 within 1."""
    loader = jcollate.BatchLoader(iter(jscenes.SceneDataset(env["data"], seed=0)),
                                  jcollate.DualSourceCollate(imsize=16, seed=0),
                                  batch_size=2, num_threads=1)
    raw = next(loader)
    loader.close()
    noise = np.random.RandomState(9).randn(2, 16, 16, 3).astype(np.float32)
    net, gnet = jsnapshots.load_snapshot(env["snap"]), jsnapshots.load_snapshot(env["gsnap"])
    src_j = JEncoder().encode_latents(raw["src_image"])

    @jax.jit
    def run(params, gparams, src, geo, noise):
        den = jsampler.make_denoiser(params, net.cfg, src=src, geometry=geo)
        gden = jsampler.make_denoiser(gparams, gnet.cfg)
        return jsampler.edm_sampler(den, noise, gnet_denoise=gden, num_steps=4, guidance=1.5)

    want = np.asarray(JEncoder().decode(run(net.params, gnet.params, src_j,
                                            raw["geometry"], noise)))
    tnet, tgnet = snapshots.load_snapshot(env["snap"]), snapshots.load_snapshot(env["gsnap"])
    enc = StandardRGBEncoder()
    latents = sampler.edm_sampler(
        sampler.make_denoiser(tnet.net, enc.encode_latents(raw["src_image"]),
                              torch.from_numpy(raw["geometry"])),
        torch.from_numpy(noise), gnet_denoise=sampler.make_denoiser(tgnet.net),
        num_steps=4, guidance=1.5)
    got = enc.decode(latents)
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 16, 16, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_generate_writes_triplets(env):
    outdir = str(env["root"] / "out")
    batches = list(generate_images_nvs(net=env["snap"], gnet=env["gsnap"], guidance=1.5,
                                       outdir=outdir, seeds=range(0, 3), max_batch_size=2,
                                       datakwargs={"path": env["data"]}, num_steps=2,
                                       verbose=False, device="cpu"))
    assert [len(b.seeds) for b in batches] == [2, 1]
    files = set(os.listdir(outdir))
    for seed in range(3):
        for prefix in ("src", "tgt", "sample"):
            assert f"{prefix}_{seed:06d}.png" in files
    assert batches[0].images.dtype == np.uint8 and batches[0].images.shape == (2, 16, 16, 3)
    with pytest.raises(NotImplementedError):
        generate_images_nvs(net=env["snap"], datakwargs={"path": env["data"]},
                            depth_model="depth.pkl", verbose=False, device="cpu")


def test_port_runs_without_jax(tmp_path):
    """Every port module imports (the kernel labs of `tools` among them), the
    [B, H, S, D] attention entries, the no-max packed forward and the labs'
    kernels' wrappers run, the trainer CLI takes one step and the generation
    CLI samples a guided base -> SR cascade on the CPU, with jax and
    vivid_tpu made unimportable."""
    script = textwrap.dedent(f"""
        import importlib, os, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["vivid_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        import vivid_tpu_torch
        for m in pkgutil.walk_packages(vivid_tpu_torch.__path__, "vivid_tpu_torch."):
            importlib.import_module(m.name)
        from vivid_tpu_torch.kernels import attention, flash
        from vivid_tpu_torch.tools import bigs_attn_lab, fused_conv_lab, nomax_attn_lab
        x = torch.randn(1, 2, 16, 16)
        assert attention.attention_from_raw(x, x, x, zero_sink=4).shape == x.shape
        assert attention.fused_attention(x, x, x).shape == x.shape
        assert flash.flash_nomax_packed(torch.randn(1, 16, 96), (), 2).shape == (1, 16, 32)
        assert nomax_attn_lab.nomax_attention(x, x, x, True, 2, True).shape == x.shape
        assert len(fused_conv_lab.main(["--device", "cpu", "--batch", "1", "--res", "8"])) == 2
        assert callable(bigs_attn_lab.main)
        from vivid_tpu_torch.data.scenes import make_synthetic_dataset
        from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
        from vivid_tpu_torch.train.snapshots import save_snapshot
        from vivid_tpu_torch.cli.generate_images import cmdline
        from vivid_tpu_torch.cli import train_nvs
        tiny = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1,
                    attn_resolutions=(8,), channels_per_head=8, use_bf16=False)
        root = {str(tmp_path)!r}
        data = make_synthetic_dataset(os.path.join(root, "scenes"), num_scenes=2,
                                      num_views=4, imsize=16)
        save_snapshot(os.path.join(root, "b.pkl"),
                      NVPrecond(PrecondConfig(img_resolution=16, **tiny), seed=0))
        save_snapshot(os.path.join(root, "u.pkl"),
                      NVPrecond(PrecondConfig(img_resolution=16, uncond=True, **tiny), seed=1))
        save_snapshot(os.path.join(root, "s.pkl"),
                      NVPrecond(PrecondConfig(img_resolution=32, super_res=True, num_sources=1,
                                              source_label_dim=20, target_label_dim=20,
                                              **tiny), seed=2))
        trained = train_nvs.cmdline(
            ["--data", data, "--outdir", os.path.join(root, "run"), "--device", "cpu",
             "--channels", "16", "--batch", "2", "--bf16", "false", "--max-steps", "1",
             "--snapshot", "12"], standalone_mode=False)
        assert trained.state.adam_step == 1 and trained.state.cur_nimg == 12
        assert len([f for f in os.listdir(os.path.join(root, "run", "experiments"))
                    if f.endswith(".pkl")]) == 2
        cmdline(["--net", os.path.join(root, "b.pkl"), "--gnet", os.path.join(root, "u.pkl"),
                 "--guidance", "1.5", "--sr-model", os.path.join(root, "s.pkl"),
                 "--device", "cpu", "--data", data, "--outdir", os.path.join(root, "out"),
                 "--seeds", "0-1", "--steps", "2"], standalone_mode=False)
        import PIL.Image
        assert PIL.Image.open(os.path.join(root, "out", "sample_000000.png")).size == (32, 32)
        assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
        print("ok")
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")
    assert sorted(os.listdir(tmp_path / "out")) == [
        f"{p}_{s:06d}.png" for p in ("sample", "src", "tgt") for s in (0, 1)]
