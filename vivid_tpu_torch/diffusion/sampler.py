"""Second-order Heun EDM sampler with autoguidance.

Counterpart of vivid_tpu/diffusion/sampler.py. The JAX package scans 2N-1
half-steps in one compiled program; here a Python loop makes the same
2N-1 denoiser evaluations: N-1 Heun steps, then a final Euler step to
sigma = 0. Guidance is D = ref + g * (D - ref), `ref` from the weaker or
unconditional net. Churn noise (S_churn > 0) comes from per-seed
generators with the step index folded in, so sample i depends on seeds[i]
alone.
"""

import math
from typing import Callable, Optional

import numpy as np
import torch

from vivid_tpu_torch.core.rngs import seeded_normal


def sigma_schedule(num_steps=32, sigma_min=0.002, sigma_max=80.0, rho=7.0):
    """EDM rho-schedule plus the terminal zero, float32 numpy."""
    i = np.arange(num_steps, dtype=np.float64)
    t = (sigma_max ** (1 / rho)
         + i / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.concatenate([t, [0.0]]).astype(np.float32)


@torch.no_grad()
def edm_sampler(denoise: Callable, noise: torch.Tensor,
                gnet_denoise: Optional[Callable] = None,
                num_steps: int = 32, sigma_min: float = 0.002,
                sigma_max: float = 80.0, rho: float = 7.0, guidance: float = 1.0,
                S_churn: float = 0.0, S_min: float = 0.0,
                S_max: float = float("inf"), S_noise: float = 1.0,
                seeds=None) -> torch.Tensor:
    """denoise(x, t[B]) -> D_x; noise [B, H, W, C] ~ N(0, 1). Returns the
    final latents in fp32. `seeds` ([B] ints) is needed when S_churn > 0."""
    t_steps = sigma_schedule(num_steps, sigma_min, sigma_max, rho)
    b = noise.shape[0]

    def guided(x, t):
        tt = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        d = denoise(x, tt)
        if gnet_denoise is None:
            return d
        ref = gnet_denoise(x, tt)
        return ref + guidance * (d - ref)

    churn = min(S_churn / num_steps, math.sqrt(2.0) - 1.0) if S_churn > 0 else 0.0
    if churn > 0 and seeds is None:
        raise ValueError("S_churn > 0 needs per-sample seeds")

    x_next = noise.float() * float(t_steps[0])
    for i in range(num_steps):
        t_cur, t_next = t_steps[i], t_steps[i + 1]
        x_cur = x_next
        gamma = np.float32(churn if S_min <= t_cur <= S_max else 0.0)
        t_hat = np.float32(t_cur + gamma * t_cur)
        x_hat = x_cur
        if gamma > 0:
            eps = seeded_normal(seeds, x_cur.shape[1:], x_cur.device, data=i + 1)
            x_hat = x_cur + float(np.sqrt(max(t_hat ** 2 - t_cur ** 2, 0.0))) * S_noise * eps
        d_cur = (x_hat - guided(x_hat, t_hat)) / float(t_hat)
        x_next = x_hat + float(np.float32(t_next - t_hat)) * d_cur
        if i < num_steps - 1:
            d_prime = (x_next - guided(x_next, t_next)) / float(t_next)
            x_next = x_hat + float(np.float32(t_next - t_hat)) * (0.5 * d_cur + 0.5 * d_prime)
    return x_next


def make_denoiser(net, src=None, geometry=None, conditioning_image=None,
                  generator=None, cond_noise=None,
                  precompute_features: Optional[bool] = None):
    """Bind an NVPrecond and its conditioning into `denoise(x, t)`. For a
    super-resolution model, `conditioning_image` [B, H, W, C] is the
    low-resolution sample at the model's resolution. The noise on it
    (noisy_sr > 0) is one draw for the whole sampling run, from `generator`
    unless the caller passes the unit noise `cond_noise`: every evaluation
    sees the same noisy image, as the JAX package's closure over one key
    gives it. A model trained with `no_time_enc` has encoder features that
    do not depend on sigma: they are computed once here (without a graph, on
    a zero target at sigma 1, as the JAX package does) and injected into
    every evaluation. `precompute_features` overrides that default
    (`no_time_enc and not uncond`)."""
    if (conditioning_image is not None and cond_noise is None
            and net.cfg.super_res and net.cfg.noisy_sr > 0):
        if generator is None:
            raise ValueError("noisy_sr > 0 needs a generator or cond_noise")
        cond_noise = torch.randn(conditioning_image.shape, generator=generator,
                                 device=conditioning_image.device)

    features = None
    if precompute_features is None:
        precompute_features = net.cfg.no_time_enc and not net.cfg.uncond
    if precompute_features:
        zero_dst = torch.zeros(src.shape[:1] + src.shape[2:], device=src.device)
        with torch.no_grad():
            features = net(src, zero_dst, torch.ones(src.shape[0], device=src.device),
                           geometry, return_features=True)

    def denoise(x, t):
        return net(src, x, t, geometry, conditioning_image=conditioning_image,
                   cond_noise=cond_noise, inject_features=features)
    return denoise
