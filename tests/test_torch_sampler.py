"""The port's guided Heun EDM sampler against vivid_tpu's, with the same
tiny snapshot weights and the same numpy noise (CPU, fp32, 4 steps), and
the per-seed noise contract of its seeded_normal."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vivid_tpu.diffusion import sampler as jsampler
from vivid_tpu.nn import precond as jprecond
from vivid_tpu_torch.compat.from_jax import from_jax
from vivid_tpu_torch.core.rngs import seeded_normal
from vivid_tpu_torch.diffusion import sampler
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig

torch.set_num_threads(1)

TINY = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1,
            attn_resolutions=(8,), channels_per_head=8, use_bf16=False,
            remat=False)


def _leaf(rng, name, shape):
    if name == "out_gain":  # keeps D_x near the data range, as a trained net's
        return rng.uniform(0.1, 0.3, shape)
    if name.endswith("gain"):
        return rng.uniform(0.5, 1.5, shape)
    return rng.randn(*shape)


def _params(cfg, seed):
    """Numpy-seeded JAX tree for `cfg`, with non-zero gains."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda k: jprecond.precond_init(k, cfg), jax.random.PRNGKey(0))

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                _leaf(rng, k, v.shape).astype(np.float32) for k, v in node.items()}
    return walk(shapes)


def _net(cfg, params):
    net = NVPrecond(PrecondConfig(**dataclasses.asdict(cfg)))
    net.load_state_dict(from_jax(params), strict=True)
    return net.eval()


def test_sigma_schedule_matches():
    np.testing.assert_array_equal(sampler.sigma_schedule(32), jsampler.sigma_schedule(32))


def test_guided_sampler_matches_jax():
    cfg = jprecond.PrecondConfig(img_resolution=16, **TINY)
    gcfg = jprecond.PrecondConfig(img_resolution=16, uncond=True, **TINY)
    params, gparams = _params(cfg, 0), _params(gcfg, 1)
    rng = np.random.RandomState(5)
    src = rng.randn(2, 2, 16, 16, 3).astype(np.float32)
    geo = rng.randn(2, 2, 20).astype(np.float32)
    noise = rng.randn(2, 16, 16, 3).astype(np.float32)

    @jax.jit
    def run(params, gparams, src, geo, noise):
        den = jsampler.make_denoiser(params, cfg, src=src, geometry=geo)
        gden = jsampler.make_denoiser(gparams, gcfg)
        return jsampler.edm_sampler(den, noise, gnet_denoise=gden, num_steps=4,
                                    guidance=1.5)

    want = np.asarray(run(params, gparams, src, geo, noise))
    net, gnet = _net(cfg, params), _net(gcfg, gparams)
    got = sampler.edm_sampler(
        sampler.make_denoiser(net, torch.from_numpy(src), torch.from_numpy(geo)),
        torch.from_numpy(noise), gnet_denoise=sampler.make_denoiser(gnet),
        num_steps=4, guidance=1.5)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_churn_needs_seeds_and_is_batch_invariant():
    den = lambda x, t: 0.5 * x  # noqa: E731
    noise = seeded_normal([3, 4], (4, 4, 3))
    with pytest.raises(ValueError):
        sampler.edm_sampler(den, noise, num_steps=3, S_churn=10)
    both = sampler.edm_sampler(den, noise, num_steps=3, S_churn=10, seeds=[3, 4])
    one = sampler.edm_sampler(den, noise[1:], num_steps=3, S_churn=10, seeds=[4])
    torch.testing.assert_close(both[1:], one)


def test_seeded_normal_is_per_seed():
    a = seeded_normal([5, 6, 7], (8, 8, 3))
    b = seeded_normal([7, 5], (8, 8, 3))
    assert a.shape == (3, 8, 8, 3) and a.dtype == torch.float32
    assert torch.equal(a[0], b[1]) and torch.equal(a[2], b[0])
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(seeded_normal([5], (4,), data=1), seeded_normal([5], (4,)))
