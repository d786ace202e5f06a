"""Magnitude-preserving primitives (EDM2).

Counterpart of vivid_tpu/nn/mp.py. Activations are channel-last
[B, H, W, C], as in the JAX package; convolutions run on the
`permute(0, 3, 1, 2)` view (NCHW in channels_last memory, no copy). Weights
keep the reference's torch layouts: conv OIHW, linear [out, in]. Norm math
runs in float32 whatever the compute dtype.

`remat_name` names what the operators run inside it put out, as
`jax.ad_checkpoint.checkpoint_name` names a value in the JAX package: an
MPConv's product is "mpconv_out", its normalised weight "wnorm", and
remat="save_dots" (nn/unet.py) keeps by these names.
"""

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

_region = threading.local()   # the name `remat_name` gives, on the thread that runs the ops


@contextlib.contextmanager
def remat_name(name: str):
    """Name the outputs of the operators run inside: a dispatch mode (the
    recompute policy) reads it with `current_remat_name`. Nothing is copied."""
    outer = getattr(_region, "name", None)
    _region.name = name
    try:
        yield
    finally:
        _region.name = outer


def current_remat_name():
    """The name of the innermost `remat_name` on this thread, None outside."""
    return getattr(_region, "name", None)


def normalize(x, dim=None, eps: float = 1e-4):
    """Unit-RMS scaling over `dim` (default: all dims but the first):
    x / (eps + ||x|| / sqrt(N)). The norm is fp32, the divide in x.dtype."""
    if dim is None:
        dim = tuple(range(1, x.ndim))
    elif isinstance(dim, int):
        dim = (dim,)
    x32 = x.float()
    norm = torch.sqrt(x32.square().sum(dim=dim, keepdim=True))
    denom = eps + math.sqrt(norm.numel() / x.numel()) * norm
    return x / denom.to(x.dtype)


def mp_silu(x):
    """Magnitude-preserving SiLU (EDM2 Eq. 81)."""
    return F.silu(x) / 0.596


def mp_sum(a, b, t=0.5):
    """Magnitude-preserving lerp (EDM2 Eq. 88)."""
    return (a + t * (b - a)) / math.sqrt((1 - t) ** 2 + t ** 2)


def cat_weights(na: int, nb: int, t: float = 0.5):
    """The scales (wa, wb) of `mp_cat`'s two parts of na and nb channels."""
    c = math.sqrt((na + nb) / ((1 - t) ** 2 + t ** 2))
    return c / math.sqrt(na) * (1 - t), c / math.sqrt(nb) * t


def mp_cat(a, b, dim=-1, t=0.5):
    """Magnitude-preserving concatenation (EDM2 Eq. 103)."""
    wa, wb = cat_weights(a.shape[dim], b.shape[dim], t)
    return torch.cat([wa * a, wb * b], dim=dim)


def resample(x, mode: str = "keep"):
    """2x up/down-sampling of [B, H, W, C] with the fixed [1, 1] filter:
    down is a 2x2 mean, up a nearest-neighbour repeat."""
    if mode == "keep":
        return x
    b, h, w, c = x.shape
    if mode == "down":
        return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    if mode != "up":
        raise ValueError(f"unknown resample mode {mode!r}")
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class MPFourier(nn.Module):
    """Random Fourier features (EDM2 Eq. 75); freqs/phases are buffers."""

    def __init__(self, num_channels: int, device=None):
        super().__init__()
        self.register_buffer("freqs", torch.empty(num_channels, device=device))
        self.register_buffer("phases", torch.empty(num_channels, device=device))

    def reset_parameters(self, gen: torch.Generator):
        self.freqs.copy_(2 * math.pi * torch.randn(
            self.freqs.shape, generator=gen, device=self.freqs.device))
        self.phases.copy_(2 * math.pi * torch.rand(
            self.phases.shape, generator=gen, device=self.phases.device))

    def forward(self, x):
        """[...] scalars -> [..., C] features, fp32 math, result in x.dtype."""
        y = x.float()[..., None] * self.freqs.float() + self.phases.float()
        return (torch.cos(y) * math.sqrt(2.0)).to(x.dtype)


class MPConv(nn.Module):
    """Magnitude-preserving conv / linear (EDM2 Eq. 47) with forward-time
    weight normalisation. kernel=() is a linear [out, in]; (kh, kw) a
    same-padded conv OIHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(), device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels, *kernel), device=device))

    def reset_parameters(self, gen: torch.Generator):
        self.weight.copy_(torch.randn(self.weight.shape, generator=gen,
                                      device=self.weight.device))

    def normalized_weight(self, dtype, gain=1.0, rows=None, cols=None):
        """Each output filter scaled to L2 norm `gain` (fp32), then cast;
        `rows` / `cols` (slices) keep some output / input channels of the
        weight, normalised whole first (tensor parallelism: a slice of the
        input channels normalised by itself would have another norm). The
        last operator, the cast or, where there is none, the gain's product,
        puts out the "wnorm" of the JAX package."""
        w = self.weight.float()
        dims = tuple(range(1, w.ndim))
        norm = torch.sqrt(w.square().sum(dim=dims, keepdim=True))
        w = w / (1e-4 + math.sqrt(norm.numel() / w.numel()) * norm)
        scale = gain / math.sqrt(w[0].numel())
        if rows is not None:
            w = w[rows]
        if cols is not None:
            w = w[:, cols]
        if w.dtype == dtype:
            with remat_name("wnorm"):
                return w * scale
        w = w * scale
        with remat_name("wnorm"):
            return w.to(dtype)

    def forward(self, x, gain=1.0, rows=None, cols=None):
        """Linear on [..., in] or conv on [B, H, W, in] (channel-last), with
        the output channels `rows` of the whole and its input channels `cols`
        (slices; None: all). The product is "mpconv_out"."""
        w = self.normalized_weight(x.dtype, gain, rows, cols)
        with remat_name("mpconv_out"):
            if w.ndim == 2:
                return F.linear(x, w)
            y = F.conv2d(x.permute(0, 3, 1, 2), w,
                         padding=(w.shape[2] // 2, w.shape[3] // 2))
        return y.permute(0, 2, 3, 1)


def force_weight_normalize(module: nn.Module):
    """Forced weight normalisation (EDM2 Eq. 66): every MPConv weight under
    `module` is rescaled in place, under no_grad, to unit RMS per output
    filter. The trainer applies it after each optimizer step when asked.
    Under FSDP each rank rescales its own rows: the weights are sharded on
    dim 0, so every output filter is whole on one rank."""
    from vivid_tpu_torch.core.sharding import local
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, MPConv):
                w = local(sub.weight)
                if w.numel() == 0:   # a rank that holds none of this weight's rows
                    continue
                dims = tuple(range(1, w.ndim))
                norm = torch.sqrt(w.float().square().sum(dim=dims, keepdim=True))
                w.copy_(w / (1e-4 + math.sqrt(norm.numel() / w.numel()) * norm))
