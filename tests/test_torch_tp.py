"""Tensor-parallel evaluation (`generate_images_nvs(tp=...)`, `--tp`) over
two gloo ranks on the CPU.

The config has 3 heads at 16x16, which tp = 2 does not divide (those blocks
run whole on both ranks, as the JAX package leaves such dims unsharded), and
6 heads at 8x8 (3 a rank). One NVPrecond call, conditioned with the
epipolar bias and unconditional, is held to the port at tp = 1 and to the
JAX package's forward (fp32, plain versions: relative L2 1e-4, as
tests/test_torch_model.py), and both ranks must give the same bits. The
planted fault, each row-parallel weight slice normalised by itself instead
of the whole weight, must miss that by far. Guided sampling through
`generate_images_nvs` with tp = 2: both ranks sample the same latents, the
first writes the PNGs and hands the images on, the second yields rows
without images, and the latents are tp = 1's within 1e-3 (relative L2;
the all-reduce sums in another order). The sampled nets keep a fresh init's
emb gains at 0: with them at 1 these random nets multiply a rounding
difference by 3-4 in every decoder block.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from vivid_tpu.nn import precond as jprecond
from vivid_tpu_torch.compat.from_jax import from_jax, to_jax
from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.data import scenes
from vivid_tpu_torch.generate import generate_images_nvs
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig

from test_torch_model import RTOL, _params
from torch_dist_worker import run_ranks, tp_generate_job, tp_job

torch.set_num_threads(1)

TP_NET = dict(img_resolution=16, model_channels=24, channel_mult=(1, 2), num_blocks=1,
              attn_resolutions=(16, 8), channels_per_head=8, use_bf16=False, remat=False)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def cases():
    out = []
    for uncond, seed in ((False, 21), (True, 22)):
        jcfg = jprecond.PrecondConfig(uncond=uncond, epipolar_attention_bias=not uncond,
                                      **TP_NET)
        params = _params(lambda k: jprecond.precond_init(k, jcfg), seed)
        rng = np.random.RandomState(seed)
        inputs = (rng.randn(2, 2, 16, 16, 3).astype(np.float32),
                  rng.randn(2, 16, 16, 3).astype(np.float32),
                  np.array([0.3, 2.5], np.float32),
                  (0.3 * rng.randn(2, 2, 20)).astype(np.float32))
        want = np.asarray(jax.jit(lambda p, *a: jprecond.precond_apply(p, jcfg, *a))(
            params, *inputs))
        out.append(EasyDict(cfg=dataclasses.asdict(jcfg), params=params, inputs=inputs,
                            want=want, uncond=uncond))
    return out


def test_tp_forward_matches_tp1_and_jax(cases, tmp_path):
    ranks = run_ranks(tp_job, 2, tmp_path,
                      cases=[(c.cfg, c.params, c.inputs, i == 0) for i, c in enumerate(cases)])
    for i, case in enumerate(cases):
        got = [r[i] for r in ranks]
        np.testing.assert_array_equal(got[0]["out"], got[1]["out"])
        assert _rel(got[0]["out"], case.want) <= RTOL
        net = NVPrecond(PrecondConfig(**case.cfg)).eval()
        net.load_state_dict(from_jax(case.params), strict=True)
        with torch.no_grad():
            tp1 = net(*(torch.from_numpy(a) for a in case.inputs)).numpy()
        assert _rel(got[0]["out"], tp1) <= RTOL
        # 16x16 blocks whole (3 heads), 8x8 split: 3 of its 6 heads a rank.
        assert got[0]["whole_attention"] and all("16x16" in n for n in got[0]["whole_attention"])
        assert any("8x8" in n for n in got[0]["split"])
        assert got[0]["heads"] == [3]
        assert "evaluation only" in got[0]["train_refused"]
        if i == 0:
            for r in got:
                assert _rel(r["faulty"], case.want) > 100 * RTOL, _rel(r["faulty"], case.want)


def _snapshot(uncond, seed):
    cfg = PrecondConfig(uncond=uncond, **TP_NET)
    net = NVPrecond(cfg, seed=seed)
    with torch.no_grad():   # F_x on; the emb gains stay 0, as a fresh init has them
        net.unet.out_gain.fill_(1.0)
    return dict(cfg=dataclasses.asdict(cfg), params=to_jax(net.state_dict())), net


def test_tp_guided_sampling(tmp_path):
    data = scenes.make_synthetic_dataset(str(tmp_path / "scenes"), num_scenes=2, num_views=4,
                                         imsize=16)
    (base, base_net), (gnet, gnet_net) = _snapshot(False, 31), _snapshot(True, 32)
    seeds = [0, 1, 2]
    outdir = str(tmp_path / "out")
    ranks = run_ranks(tp_generate_job, 2, tmp_path, net=base, gnet=gnet, data=data,
                      outdir=outdir, seeds=seeds, num_steps=2)
    assert len(ranks[0]["sampled"]) == len(ranks[1]["sampled"]) == 1
    np.testing.assert_array_equal(ranks[0]["sampled"][0], ranks[1]["sampled"][0])
    assert [r["seeds"] for r in ranks[0]["rows"]] == [r["seeds"] for r in ranks[1]["rows"]] \
        == [seeds]
    assert ranks[1]["rows"][0]["images"] is None
    assert sorted(os.listdir(outdir)) == sorted(
        f"{p}_{s:06d}.png" for p in ("src", "tgt", "sample") for s in seeds)
    one = list(generate_images_nvs(
        net=EasyDict(net=base_net.eval(), cfg=base_net.cfg),
        gnet=EasyDict(net=gnet_net.eval(), cfg=gnet_net.cfg), guidance=1.5, seeds=seeds,
        max_batch_size=len(seeds), num_steps=2, datakwargs={"path": data}, device="cpu",
        verbose=False))
    assert _rel(ranks[0]["sampled"][0], one[0].latents.numpy()) <= 1e-3
    assert np.abs(ranks[0]["rows"][0]["images"].astype(int) - one[0].images).max() <= 1
