"""Epipolar geometry for the attention bias.

Counterpart of vivid_tpu/geometry/epipolar.py. `get_epipolar_dist` gives,
for each target-patch ray projected into the source view, its distance to
every source patch centre, || (a - p) - ((a - p).n) n ||, as [B, S_tgt,
S_src]; `get_epipolar_attn` turns it into a per-head additive logit bias
with the learned `epipolar_mixing`.
"""

import math

import torch

from vivid_tpu_torch.geometry.codec import decompose_geometry


def get_epipolar_dist(geometry, imsize, patch_size, generator=None):
    """geometry [B, 20] normalised codec vectors -> [B, S, S] with
    S = (imsize // patch_size) ** 2. A pose without translation has no
    epipolar lines, so exact zeros of the translation are replaced by a
    minimal random one drawn from `generator` (default: seed 0 on the
    tensor's device; the draw differs from the JAX package's)."""
    if generator is None:
        generator = torch.Generator(device=geometry.device).manual_seed(0)
    tgt2src, src_K, tgt_K = decompose_geometry(geometry[:, None], imsize=imsize)
    batch = tgt2src.shape[0]
    dev, dt = geometry.device, geometry.dtype

    t_xy = tgt2src[..., :2, 3]
    t_z = tgt2src[..., 2, 3]
    t_xy = torch.where(t_xy != 0, t_xy, 1e-5 * torch.randn(
        t_xy.shape, generator=generator, device=dev, dtype=dt))
    sign = 2.0 * torch.randint(0, 2, t_z.shape, generator=generator, device=dev).to(dt) - 1.0
    t_z = torch.where(t_z.abs() > 1e-5, t_z, 1e-1 * t_xy.square().sum(-1).sqrt() * sign)
    tgt2src = torch.cat([tgt2src[..., :3], torch.cat([t_xy, t_z[..., None]], -1)[..., None]], -1)

    # Patch-centre pixel grid, homogeneous: [B, h, w, 3]. The K matrices are
    # [B, 1, 3, 3], so the batch dims broadcast as (B, h) x (B, 1).
    coords = torch.arange(0, imsize, patch_size, device=dev, dtype=dt) + 0.5 * patch_size
    vv, uu = torch.meshgrid(coords, coords, indexing="ij")
    xyz = torch.stack([uu, vv, torch.ones_like(uu)], -1).expand(batch, -1, -1, -1)

    xyz1 = torch.cat([xyz @ torch.linalg.inv(tgt_K).transpose(-1, -2),
                      torch.ones_like(xyz[..., :1])], -1)
    tgt_xyz = (xyz1 @ tgt2src.transpose(-1, -2))[..., :3] @ src_K.transpose(-1, -2)
    tgt_xyz = tgt_xyz / tgt_xyz[..., 2:3]
    tgt_o = tgt2src[..., :3, 3][..., None, :] @ src_K.transpose(-1, -2)
    tgt_o = tgt_o / tgt_o[..., 2:3]

    a = (xyz - tgt_o).reshape(batch, -1, 1, 3)[..., :2]
    b = (tgt_xyz - tgt_o).reshape(batch, 1, -1, 3)[..., :2]
    b = b / b.square().sum(-1, keepdim=True).sqrt()
    d = (a - (a * b).sum(-1, keepdim=True) * b).square().sum(-1).sqrt()
    return d.transpose(-1, -2).contiguous()


def get_epipolar_attn(epipolar_dist, epipolar_mixing, patch_size=1):
    """epipolar_dist [B, S_q, S_k]; epipolar_mixing [4, H] learned (mixing,
    log-temperature, cutoff offset, bias) -> [B, H, S_q, S_k]:
    mixing * sigmoid(temperature * (cutoff - dist)) + bias."""
    d = epipolar_dist[:, None]
    mixing, log_temp, offset, bias = (row.reshape(1, -1, 1, 1) for row in epipolar_mixing)
    cutoff = patch_size / math.sqrt(2.0) + offset
    return mixing * torch.sigmoid(torch.exp(log_temp) * (cutoff - d)) + bias
