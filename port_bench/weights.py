"""Seeded weights: every tensor of a network's state dict drawn on the device
from the run's seed, in one call for the whole network, under the
reference's names. The program and the reference each get these tensors;
neither makes its own.

Weights and gains are N(0, 1) (the gains too, so that every layer of the
net carries signal and gradient); the Fourier features are the published
initialisation, frequencies 2 pi N(0, 1) and phases 2 pi U(0, 1) (the
uniform taken through the normal's CDF, from the same draw).
"""

import math
import zlib
from typing import Dict

import torch
from torch import nn

from port_bench.reference.sampling import fold_in


def seeded_state(model: nn.Module, seed: int, tag: str, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for `model`'s state dict (shapes only are read, so the
    model may live on the meta device), float32 on `device`, a function of
    (seed, tag) alone."""
    shapes = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(fold_in(seed, zlib.crc32(tag.encode())))
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[offset:offset + n].view(shape)
        offset += n
        if name.endswith("freqs"):
            t.mul_(2 * math.pi)
        elif name.endswith("phases"):
            t.copy_(torch.special.ndtr(t) * (2 * math.pi))
        out[name] = t
    return out
