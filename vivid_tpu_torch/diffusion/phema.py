"""Power-function EMA (EDM2): the profile algebra and the online update.

Counterpart of vivid_tpu/diffusion/phema.py without the post-hoc
reconstruction and the half-life EMA, which are not ported yet. An EMA with
exponent g realised at training time T weights the parameter trajectory by
p(t) = (g + 1) t^g / T^(g + 1); its width is given as the profile's relative
standard deviation `std`, and one step of the online tracker is

    beta = (1 - dt / t) ** (std_to_exp(std) + 1)
    ema <- ema + (1 - beta) * (p - ema)

The update runs in place on lists of tensors.
"""

import numpy as np
import torch


def exp_to_std(exp):
    """Relative width of the profile: var / T^2 = (g+1) / ((g+2)^2 (g+3))."""
    g = np.asarray(exp, np.float64)
    m1 = (g + 1) / (g + 2)
    m2 = (g + 1) / (g + 3)
    return np.sqrt(m2 - m1 * m1)


def std_to_exp(std):
    """Inverse of `exp_to_std`: the largest real root of
    g^3 + 7 g^2 + (16 - std^-2) g + (12 - std^-2) = 0."""
    std = np.asarray(std, np.float64)
    out = np.empty(std.shape, np.float64)
    flat = out.reshape(-1)
    for i, sigma in enumerate(std.reshape(-1)):
        c = 1.0 / (sigma * sigma)
        flat[i] = np.roots([1.0, 7.0, 16.0 - c, 12.0 - c]).real.max()
    return out


def power_function_beta(std, t_next, t_delta):
    """Per-step decay that realises the profile online:
    (1 - t_delta / t_next) ** (std_to_exp(std) + 1)."""
    exponent = float(std_to_exp(np.float64(std)) + 1)
    return (1 - t_delta / t_next) ** exponent


def ema_update(emas, params, cur_nimg, batch_size, stds):
    """In place: emas[i] (a list of tensors aligned with `params`) moves
    towards `params` by 1 - beta(stds[i]) at t = max(cur_nimg, batch_size)."""
    with torch.no_grad():
        for std, ema in zip(stds, emas):
            beta = power_function_beta(std, max(float(cur_nimg), float(batch_size)),
                                       float(batch_size))
            torch._foreach_add_(ema, torch._foreach_sub(params, ema), alpha=1.0 - beta)


class PowerFunctionEMA:
    """One tracked copy of `params` (a list of tensors) per std."""

    def __init__(self, params, stds=(0.050, 0.100)):
        self.stds = list(stds)
        self.reset(params)

    def reset(self, params):
        self.emas = [[p.detach().clone() for p in params] for _ in self.stds]

    def update(self, params, cur_nimg, batch_size):
        ema_update(self.emas, list(params), cur_nimg, batch_size, self.stds)

    def get(self):
        """[(tensors, '-0.050'-style suffix)] for snapshot names."""
        return [(ema, f"-{std:.3f}") for std, ema in zip(self.stds, self.emas)]
