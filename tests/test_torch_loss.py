"""The port's training loss, loss clamp, learning-rate schedule and
power-function EMA algebra against the JAX package (CPU, fp32, tiny widths).
torch generators cannot give JAX's random bits, so the JAX side's own sigma
and noise draws are fed through the port's loss."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.diffusion import loss as jloss
from vivid_tpu.diffusion import lr as jlr
from vivid_tpu.diffusion import phema as jphema
from vivid_tpu.nn import precond as jprecond
from vivid_tpu_torch.compat.from_jax import from_jax
from vivid_tpu_torch.diffusion import loss, lr, phema
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig

from test_torch_model import TINY, _params

torch.set_num_threads(1)


def jax_draws(loss_fn, rng, tgt_shape):
    """sigma [B, 1, 1, 1] and the unit noise exactly as jloss.NVLoss draws them."""
    k_sigma, k_noise, _ = jax.random.split(rng, 3)
    sigma = loss_fn.sample_sigma(k_sigma, tgt_shape[0])
    eps = jax.random.normal(k_noise, tgt_shape, jnp.float32)
    return np.asarray(sigma), np.asarray(eps)


@pytest.mark.parametrize("uncond,plain_mse", [(False, False), (True, False), (False, True)])
def test_nvloss_matches_jax(uncond, plain_mse):
    """Elementwise loss with JAX's draws; rel L2 1e-4 (fp32, other sum order)."""
    jcfg = jprecond.PrecondConfig(img_resolution=16, uncond=uncond, extra_attn=1, **TINY)
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 5)
    rng = np.random.RandomState(5)
    src = rng.randn(2, 2, 16, 16, 3).astype(np.float32)
    tgt = rng.randn(2, 16, 16, 3).astype(np.float32)
    geo = rng.randn(2, 2, 20).astype(np.float32)
    jfn = jloss.NVLoss(P_mean=-0.8, P_std=1.6, plain_mse=plain_mse)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda p: jfn(p, jcfg, key, src, tgt, geo, train=True))(params))
    sigma, eps = jax_draws(jfn, key, tgt.shape)

    net = NVPrecond(PrecondConfig(**dataclasses.asdict(jcfg)))
    net.load_state_dict(from_jax(params), strict=True)
    tfn = loss.NVLoss(P_mean=-0.8, P_std=1.6, plain_mse=plain_mse)
    with torch.no_grad():
        got = tfn(net.train(), torch.from_numpy(src), torch.from_numpy(tgt),
                  torch.from_numpy(geo), sigma=torch.from_numpy(sigma),
                  eps=torch.from_numpy(eps)).numpy()
    assert got.shape == want.shape == (() if plain_mse else (2, 16, 16, 3))
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= 1e-4, err


def test_nvloss_draws_from_its_generator():
    cfg = PrecondConfig(img_resolution=16, **TINY)
    net = NVPrecond(cfg, seed=0)
    fn = loss.NVLoss()
    args = (torch.zeros(2, 2, 16, 16, 3), torch.zeros(2, 16, 16, 3), torch.zeros(2, 2, 20))
    with torch.no_grad():
        a = fn(net, *args, generator=torch.Generator().manual_seed(1))
        b = fn(net, *args, generator=torch.Generator().manual_seed(1))
        c = fn(net, *args, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    sig = fn.sample_sigma(torch.Generator().manual_seed(0), 4096, "cpu")
    assert sig.shape == (4096, 1, 1, 1)
    # log sigma ~ N(P_mean, P_std): mean within 4 standard errors.
    assert abs(float(sig.log().mean()) - fn.P_mean) < 4 * fn.P_std / 64


def test_clamp_loss_uses_the_population_std():
    x = np.random.RandomState(0).standard_cauchy((4, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jloss.clamp_loss(jnp.asarray(x)))
    got = loss.clamp_loss(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got != x).any()      # the heavy tails were clamped
    # With few elements the unbiased std would clamp elsewhere.
    y = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 100.0], np.float32)
    np.testing.assert_allclose(loss.clamp_loss(torch.from_numpy(y)).numpy(),
                               np.asarray(jloss.clamp_loss(jnp.asarray(y))), rtol=1e-6)
    t = torch.from_numpy(x).requires_grad_()
    loss.clamp_loss(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), (got == x).astype(np.float32))


@pytest.mark.parametrize("kw", [dict(), dict(rampup_Mimg=0.0), dict(ref_batches=0.0),
                                dict(ref_lr=0.012, ref_batches=35e3)])
def test_learning_rate_schedule_matches_jax(kw):
    """Host floats against JAX's float32: relative 1e-6."""
    for nimg in (0, 1, 6144, 10_000_000, 10_000_001, 71_680_000, 10 ** 9):
        want = float(jlr.learning_rate_schedule(nimg, 1024, **kw))
        got = lr.learning_rate_schedule(nimg, 1024, **kw)
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (nimg, kw)
    if kw.get("rampup_Mimg", 10.0) > 0:
        assert lr.learning_rate_schedule(0, 1024, **kw) == 0.0


def test_phema_algebra_matches_jax():
    stds = np.array([0.01, 0.05, 0.1, 0.2])
    np.testing.assert_allclose(phema.std_to_exp(stds), jphema.std_to_exp(stds), rtol=0, atol=1e-12)
    exps = np.array([0.5, 3.0, 6.94, 50.0])
    np.testing.assert_allclose(phema.exp_to_std(exps), jphema.exp_to_std(exps), rtol=0, atol=1e-12)
    np.testing.assert_allclose(phema.exp_to_std(phema.std_to_exp(stds)), stds, atol=1e-12)
    for std in (0.05, 0.1):
        for t, dt in ((2048.0, 1024.0), (1e6, 1024.0), (1024.0, 1024.0)):
            assert phema.power_function_beta(std, t, dt) == pytest.approx(
                jphema.power_function_beta(std, t, dt), abs=1e-12)


def test_ema_update_matches_jax():
    rng = np.random.RandomState(0)
    params = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    emas = [[rng.randn(*p.shape).astype(np.float32) for p in params] for _ in range(2)]
    stds = (0.05, 0.1)
    want = jphema.ema_update([[jnp.asarray(e) for e in ema] for ema in emas],
                             [jnp.asarray(p) for p in params], 6144.0, 1024.0, stds)
    tracker = phema.PowerFunctionEMA([torch.from_numpy(p) for p in params], stds)
    tracker.emas = [[torch.from_numpy(e.copy()) for e in ema] for ema in emas]
    tracker.update([torch.from_numpy(p) for p in params], 6144, 1024)
    for got_ema, want_ema in zip(tracker.emas, want):
        for g, w in zip(got_ema, want_ema):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    assert [s for _, s in tracker.get()] == ["-0.050", "-0.100"]
    # At t = batch_size, beta = 0: the EMA jumps onto the parameters.
    tracker.update([torch.from_numpy(p) for p in params], 0, 1024)
    for g, p in zip(tracker.emas[0], params):
        np.testing.assert_array_equal(g.numpy(), p)
