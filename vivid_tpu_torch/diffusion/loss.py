"""EDM2 training loss with learned-uncertainty weighting.

Counterpart of vivid_tpu/diffusion/loss.py `NVLoss`, `SRNVLoss`,
`clamp_loss` and `down_up_resize`. Sigma and noise are drawn once per pair:

    sigma  = exp(N(0, 1) * P_std + P_mean)              [B, 1, 1, 1]
    weight = (sigma^2 + sd^2) / (sigma * sd)^2
    loss   = weight * exp(-logvar) * (D(tgt + sigma * eps) - tgt)^2 + logvar

with logvar clamped to +-logvar_clamp. `plain_mse` returns the weighted MSE's
mean instead. The draws come from a `torch.Generator`; a caller (a test that
feeds both packages the same numbers) may pass `sigma` and the unit noise
`eps` itself. `SRNVLoss` trains the super-resolution model: it conditions
the net on the target resized down by 4 and back up, and draws the unit
noise that `super_res` preconditioning adds to that image (`noisy_sr`) anew
on every call.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F


def down_up_resize(x, factor: int = 4):
    """The low-resolution conditioning of the super-resolution model from a
    full-resolution [B, H, W, C] image: antialiased bilinear down by
    `factor`, plain bilinear back up (torchvision's resize chain, which the
    JAX package rebuilt as matrix products)."""
    b, h, w, c = x.shape
    y = x.float().permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(h // factor, w // factor), mode="bilinear",
                      antialias=True, align_corners=False)
    y = F.interpolate(y, size=(h, w), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def global_moments(x, group=None):
    """(count, mean, population std) of the elements of `x`, detached, from
    (count, sum, sum of squares) in fp64: this process's alone without
    `group`, every rank's with one (one all-reduce on the group's device).
    So one process and several take the same statistic of the same values.
    Mean and std come in x's dtype on x's device."""
    x64 = x.detach().double()
    t = torch.stack([torch.tensor(float(x.numel()), dtype=torch.float64, device=x.device),
                     x64.sum(), x64.square().sum()])
    if group is not None:
        from vivid_tpu_torch.core import dist
        t = t.to(dist.group_device(group))
        torch.distributed.all_reduce(t, group=group)
        t = t.to(x.device)
    n, s, ss = t.unbind()
    mean = s / n
    std = torch.sqrt(torch.clamp(ss / n - mean * mean, min=0.0))
    return n, mean.to(x.dtype), std.to(x.dtype)


def clamp_loss(loss, group=None):
    """Clamp an elementwise loss to mean +- 3 std; the statistics (the
    population std, `global_moments`) carry no gradient. With a process
    group they are the global batch's, every rank's rows together, as the
    JAX step's are under GSPMD."""
    _, m, s = global_moments(loss, group)
    return torch.clamp(loss, m - 3 * s, m + 3 * s)


@dataclass(frozen=True)
class NVLoss:
    P_mean: float = -0.4
    P_std: float = 1.0
    sigma_data: float = 0.5
    plain_mse: bool = False
    logvar_clamp: float = 20.0

    def sample_sigma(self, generator, batch: int, device):
        rnd = torch.randn((batch, 1, 1, 1), generator=generator, device=device)
        return torch.exp(rnd * self.P_std + self.P_mean)

    def _noised(self, tgt, generator, sigma, eps):
        """-> (sigma [B, 1, 1, 1], the loss weight, tgt + sigma * eps), drawing
        sigma and then eps from `generator` where they are not given."""
        b = tgt.shape[0]
        if sigma is None:
            sigma = self.sample_sigma(generator, b, tgt.device)
        sigma = sigma.reshape(b, 1, 1, 1)
        if eps is None:
            eps = torch.randn(tgt.shape, generator=generator, device=tgt.device,
                              dtype=tgt.dtype)
        weight = (sigma ** 2 + self.sigma_data ** 2) / (sigma * self.sigma_data) ** 2
        return sigma, weight, tgt + eps * sigma

    def __call__(self, net, src, tgt, geometry, generator=None, sigma=None, eps=None):
        """src [B, n_src, H, W, Cs]; tgt [B, H, W, C]; geometry [B, n_src, 20].
        Returns the elementwise loss [B, H, W, C] (a scalar for plain_mse).
        `generator` feeds sigma, eps and the net's dropout, in that order."""
        b = tgt.shape[0]
        sigma, weight, noisy = self._noised(tgt, generator, sigma, eps)

        if self.plain_mse:
            denoised = net(src, noisy, sigma.reshape(b), geometry, generator=generator)
            return torch.mean(weight * (denoised - tgt) ** 2)

        denoised, logvar = net(src, noisy, sigma.reshape(b), geometry,
                               return_logvar=True, generator=generator)
        logvar = logvar.clamp(-self.logvar_clamp, self.logvar_clamp)
        return weight * torch.exp(-logvar) * (denoised - tgt) ** 2 + logvar


@dataclass(frozen=True)
class SRNVLoss(NVLoss):
    """The super-resolution variant. `plain_mse` is accepted and, as in the
    JAX package's class, not honoured: the loss is always the learned-variance
    form."""

    def __call__(self, net, src, tgt, geometry, generator=None, sigma=None, eps=None,
                 cond_noise=None):
        """As `NVLoss.__call__`; `generator` feeds sigma, eps, the conditioning
        noise and the net's dropout, in that order. `cond_noise` [B, H, W, C]
        replaces the conditioning-noise draw."""
        b = tgt.shape[0]
        sigma, weight, noisy = self._noised(tgt, generator, sigma, eps)
        if cond_noise is None and net.cfg.noisy_sr > 0:
            cond_noise = torch.randn(tgt.shape, generator=generator, device=tgt.device,
                                     dtype=tgt.dtype)
        low_res = down_up_resize(tgt, 4)
        denoised, logvar = net(src, noisy, sigma.reshape(b), geometry,
                               return_logvar=True, generator=generator,
                               conditioning_image=low_res, cond_noise=cond_noise)
        logvar = logvar.clamp(-self.logvar_clamp, self.logvar_clamp)
        return weight * torch.exp(-logvar) * (denoised - tgt) ** 2 + logvar
