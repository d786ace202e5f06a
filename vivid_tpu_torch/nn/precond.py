"""NVPrecond: EDM preconditioning around the feature encoder and the
cross-attention denoiser, with the uncertainty (logvar) head.

Counterpart of vivid_tpu/nn/precond.py with the same explicit source axis:

    src:      [B, n_src, H, W, Cs]   (n_src = 2 dual-source, 1 vanilla)
    dst:      [B, H, W, C]           noisy target
    sigma:    [B]
    geometry: [B, n_src, 20]

The encoder folds the source axis into the batch; the denoiser consumes
per-source feature stacks [B, n_src, h, w, c]. A `super_res` model (256px)
also takes a conditioning image [B, H, W, C], the low-resolution sample
resized to its resolution: N(0, noisy_sr^2) noise is added to it and it is
concatenated to the scaled input of the denoiser (U-Net kind 'sr').
The sources of a `depth_input` model carry a fourth channel, depth, which
the encoder reads. Those of a `warp_depth_coor` model carry it too; the
forward turns it into Fourier features of each source's pixel grid (for the
encoder, in place of depth) and of source 0's depth-warped grid (appended to
the denoiser's input; geometry/warp.py). The two flags together are refused.
c_skip = sd^2/(s^2+sd^2), c_out = s*sd/sqrt(s^2+sd^2),
c_in = 1/sqrt(sd^2+s^2), c_noise = log(s)/4.
Compute runs in bf16 when `use_bf16` (norm math stays fp32); D_x returns in
fp32. Parameters stay fp32 (the master weights) and are cast per call, so
the same module trains and samples.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from vivid_tpu_torch.core.trace import span
from vivid_tpu_torch.geometry.warp import get_warped_features
from vivid_tpu_torch.nn.mp import MPConv, MPFourier
from vivid_tpu_torch.nn.unet import UNet, UNetConfig


@dataclass(frozen=True)
class PrecondConfig:
    """The JAX package's PrecondConfig, field for field, so a snapshot's
    `model_cfg` loads as it is. dropout and remat shape training (nn/unet.py);
    force_wn is read by the trainer; scan_blocks and wpack only shaped the
    TPU's execution and are ignored."""
    img_resolution: int
    img_channels: int = 3
    source_label_dim: int = 20
    target_label_dim: int = 40
    use_bf16: bool = True
    sigma_data: float = 0.5
    logvar_channels: int = 128
    super_res: bool = False
    no_time_enc: bool = False
    depth_input: bool = False
    warp_depth_coor: bool = False
    uncond: bool = False
    noisy_sr: float = 0.25
    num_sources: int = 2
    model_channels: int = 192
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    channel_mult_noise: Optional[int] = None
    channel_mult_emb: Optional[int] = None
    num_blocks: int = 3
    attn_resolutions: Tuple[int, ...] = (16, 8)
    extra_attn: Optional[int] = None
    epipolar_attention_bias: bool = False
    channels_per_head: int = 64
    dropout: float = 0.0
    remat: object = True
    scan_blocks: bool = False
    force_wn: bool = False
    wpack: Optional[bool] = None

    def _unet_common(self):
        return dict(
            img_resolution=self.img_resolution,
            model_channels=self.model_channels,
            channel_mult=tuple(self.channel_mult),
            channel_mult_noise=self.channel_mult_noise,
            channel_mult_emb=self.channel_mult_emb,
            num_blocks=self.num_blocks,
            attn_resolutions=tuple(self.attn_resolutions),
            extra_attn=self.extra_attn,
            epipolar_attention_bias=self.epipolar_attention_bias,
            num_cross_sources=self.num_sources,
            channels_per_head=self.channels_per_head,
            dropout=self.dropout,
            remat=self.remat,
        )

    @property
    def encoder_cfg(self) -> Optional[UNetConfig]:
        """The encoder reads the source views: rgb, then the depth channel
        (`depth_input`) or the 128 Fourier channels of the pixel grid
        (`warp_depth_coor`)."""
        if self.uncond:
            return None
        cin = (self.img_channels + int(self.depth_input)
               + self.logvar_channels * int(self.warp_depth_coor))
        return UNetConfig(kind="encoder", img_channels=cin,
                          label_dim=self.source_label_dim, **self._unet_common())

    @property
    def unet_cfg(self) -> UNetConfig:
        """The denoiser reads the noisy view, then with `warp_depth_coor` the
        128 Fourier channels of source 0's depth-warped grid; it writes 3."""
        cin = self.img_channels + self.logvar_channels * int(self.warp_depth_coor)
        return UNetConfig(kind="sr" if self.super_res else "xattn", img_channels=cin,
                          label_dim=self.target_label_dim, **self._unet_common())


class NVPrecond(nn.Module):
    def __init__(self, cfg: PrecondConfig, device=None, seed: Optional[int] = None):
        """Parameters are allocated on `device` (use "meta" to count them
        without memory). With `seed`, they are initialised from a
        torch.Generator on that device: weights ~ N(0, 1), gains 0."""
        super().__init__()
        if cfg.depth_input and cfg.warp_depth_coor:
            # The encoder would be built for rgb + depth + grid, and the warp
            # branch feeds it rgb + grid (the JAX package crashes there).
            raise ValueError("PrecondConfig.depth_input and PrecondConfig.warp_depth_coor "
                             "cannot both be set")
        self.cfg = cfg
        self.unet = UNet(cfg.unet_cfg, device)
        self.logvar_fourier = MPFourier(cfg.logvar_channels, device)
        self.logvar_linear = MPConv(cfg.logvar_channels, 1, (), device)
        self.encoder = UNet(cfg.encoder_cfg, device) if not cfg.uncond else None
        if seed is not None:
            gen = torch.Generator(device=device or "cpu").manual_seed(seed)
            with torch.no_grad():
                for module in self.children():
                    module.reset_parameters(gen)

    @property
    def dtype(self):
        return torch.bfloat16 if self.cfg.use_bf16 else torch.float32

    def encode_sources(self, src, c_noise, geometry, generator=None):
        """Encoder over [B, n_src, H, W, Cs] -> list of [B, n_src, h, w, c]."""
        b, s = src.shape[:2]
        flat_src = src.reshape((b * s,) + src.shape[2:])
        flat_geo = geometry.reshape(b * s, -1)
        enc_noise = c_noise.repeat_interleave(s) * (0.0 if self.cfg.no_time_enc else 1.0)
        feats = self.encoder(flat_src, enc_noise, flat_geo, generator=generator)
        return [f.reshape((b, s) + f.shape[1:]) for f in feats]

    def forward(self, src, dst, sigma, geometry=None, return_logvar: bool = False,
                generator=None, conditioning_image=None, cond_noise=None,
                return_features: bool = False, inject_features=None):
        """D_x [B, H, W, C] in fp32 (and logvar [B, 1, 1, 1] on request).
        `generator` feeds the dropout masks in training mode. A `super_res`
        model needs `conditioning_image`, and with noisy_sr > 0 its unit noise
        `cond_noise` (same shape): the caller draws it, once per sampling run
        (`diffusion.sampler.make_denoiser`), never this call.
        `return_features` returns the encoder's feature list in place of D_x
        (it does not depend on `dst` or the conditioning image);
        `inject_features` takes such a list and skips the encoder, which is
        how a `no_time_enc` model is sampled with one encoder pass."""
        cfg = self.cfg
        b = dst.shape[0]
        x = dst.float()
        sigma = sigma.float().reshape(b, 1, 1, 1)
        dtype = self.dtype
        if geometry is None:
            geometry = torch.zeros(b, cfg.num_sources, 20, device=x.device)
        if cfg.uncond:
            geometry = geometry * 0.0

        sd = cfg.sigma_data
        c_skip = sd ** 2 / (sigma ** 2 + sd ** 2)
        c_out = sigma * sd / torch.sqrt(sigma ** 2 + sd ** 2)
        c_in = 1.0 / torch.sqrt(sd ** 2 + sigma ** 2)
        c_noise = torch.log(sigma.reshape(b)) / 4.0
        x_in = (c_in * x).to(dtype)

        if cfg.warp_depth_coor:
            if src is None or src.shape[-1] != 4:
                raise ValueError("warp_depth_coor requires a depth channel in src (rgb + depth)")
            n = cfg.num_sources
            depth = src[..., 3:].float()
            grid, warped = get_warped_features(
                depth.reshape((b * n,) + depth.shape[2:]), geometry.reshape(b * n, -1),
                self.logvar_fourier)
            grid = grid.reshape((b, n) + grid.shape[1:])
            src = torch.cat([src[..., :3], grid.to(src.dtype)], dim=-1)
            # The denoised view gets source 0's warped grid.
            warped = warped.reshape((b, n) + warped.shape[1:])[:, 0]
            x_in = torch.cat([x_in, warped.to(dtype)], dim=-1)

        if inject_features is not None:
            features = inject_features
        elif cfg.uncond:
            features = "zeros"
        else:
            with span("net.encoder"):
                features = self.encode_sources(src.to(dtype), c_noise, geometry, generator)
        if return_features:
            return features

        if cfg.super_res:
            if conditioning_image is None:
                raise ValueError("a super_res model requires conditioning_image")
            cond = conditioning_image.float()
            if cfg.noisy_sr > 0:
                if cond_noise is None:
                    raise ValueError("a super_res model with noisy_sr > 0 requires cond_noise")
                cond = cond + cfg.noisy_sr * cond_noise
            x_in = torch.cat([x_in, cond.to(dtype)], dim=-1)

        src_geometries = ([geometry[:, i] for i in range(cfg.num_sources)]
                          if cfg.epipolar_attention_bias else None)
        with span("net.denoiser"):
            F_x = self.unet(x_in, c_noise, geometry.reshape(b, -1), features=features,
                            generator=generator, src_geometries=src_geometries)
        D_x = c_skip * x + c_out * F_x.float()
        if return_logvar:
            logvar = self.logvar_linear(self.logvar_fourier(c_noise)).reshape(b, 1, 1, 1)
            return D_x, logvar
        return D_x
