"""Plain sampling arithmetic and the inputs it is conditioned on, worked out
from the scene files the benchmark wrote: the EDM rho-schedule, one Heun
step with autoguidance, the per-seed noise streams, the pixel codec, the
20-value camera code and the super-resolution conditioning image.
"""

import numpy as np
import torch
import torch.nn.functional as F

# The camera code's normalisation (flattened tgt2src 3x4, source fx fy cx cy,
# target fx fy cx cy), part of the published models' input contract.
GEO_MEAN = np.array([
    9.6681e-01, -1.6038e-04, -3.7034e-05, -1.6904e-03, -8.7718e-05,
    9.9869e-01, 3.1288e-03, -1.0794e-03, 1.0653e-05, 3.0997e-03,
    9.6691e-01, 1.2561e-02, 5.7708e+01, 5.7704e+01, 3.2000e+01,
    3.2000e+01, 5.7708e+01, 5.7704e+01, 3.2000e+01, 3.2000e+01], np.float32)
GEO_STD = np.array([
    0.1104, 0.0346, 0.2279, 0.4930, 0.0347, 0.0091, 0.0367, 0.2208, 0.2279,
    0.0368, 0.1088, 1.0751, 6.6464, 6.6511, 0.0000, 0.0000, 6.6464, 6.6511,
    0.0000, 0.0000], np.float32)


def sigma_steps(num_steps, sigma_min=0.002, sigma_max=80.0, rho=7.0):
    """The EDM schedule, then 0, as float32."""
    i = np.arange(num_steps, dtype=np.float64)
    t = (sigma_max ** (1 / rho)
         + i / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.append(t, 0.0).astype(np.float32)


def heun_step(denoise, x, t_cur, t_next, last: bool):
    """x at t_cur -> x at t_next: Euler, then (unless this is the last step,
    which ends at 0) the trapezoidal correction. `denoise(x, t)` is the
    guided D. Also returns D at (x, t_cur), the scale of the step's
    network part."""
    d0 = denoise(x, t_cur)
    d_cur = (x - d0) / t_cur
    dt = float(np.float32(t_next - t_cur))
    x_next = x + dt * d_cur
    if not last:
        d_prime = (x_next - denoise(x_next, t_next)) / t_next
        x_next = x + dt * (0.5 * d_cur + 0.5 * d_prime)
    return x_next, d0


def guided(net_d, guide_d, g):
    """Autoguidance: D = ref + g (D - ref)."""
    if guide_d is None:
        return net_d
    return guide_d + g * (net_d - guide_d)


def fold_in(seed: int, data: int) -> int:
    """63-bit generator seed from (seed, data)."""
    hi, lo = np.random.SeedSequence([int(seed), int(data)]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) >> 1


def seed_noise(seeds, shape, device):
    """Row i ~ N(0, 1) from a generator seeded by fold_in(seeds[i], 0)."""
    return torch.stack([
        torch.randn(tuple(shape), device=device,
                    generator=torch.Generator(device=device).manual_seed(fold_in(s, 0)))
        for s in seeds])


def encode_pixels(pixels, device):
    """[..., 3] pixels in [0, 255] -> latents x / 127.5 - 1."""
    return torch.as_tensor(np.asarray(pixels, np.float32), device=device) / 127.5 - 1


def camera_code(c2w, fxfycxcy, src, tgt, imsize):
    """The normalised 20-value code of the pose from target view `tgt` to
    source view `src`: inv(c2w[tgt]) c2w[src] (3x4), source and target
    intrinsics; the intrinsic slots' statistics scale with imsize / 64."""
    rel = (np.linalg.inv(np.asarray(c2w[tgt], np.float64))
           @ np.asarray(c2w[src], np.float64))[:3].astype(np.float32)
    code = np.concatenate([rel.reshape(12), np.asarray(fxfycxcy[src], np.float32),
                           np.asarray(fxfycxcy[tgt], np.float32)])
    mean, std = GEO_MEAN.copy(), GEO_STD.copy()
    mean[12:] *= imsize / 64
    std[12:] *= (imsize / 64) ** 2
    out = np.zeros_like(code)
    np.divide(code - mean, std, out=out, where=std > 0)
    return out


def low_res(x, factor=4):
    """The super-resolution model's conditioning: [B, H, W, C] taken down by
    `factor` (antialiased bilinear) and back up (bilinear)."""
    h, w = x.shape[1:3]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h // factor, w // factor),
                      mode="bilinear", antialias=True, align_corners=False)
    y = F.interpolate(y, size=(h, w), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
