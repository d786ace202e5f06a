"""Deterministic per-seed random streams.

Counterpart of vivid_tpu/core/rngs.py. Every sample seed gets its own
`torch.Generator`, so noise[i] depends on seeds[i] alone: invariant to batch
composition and order (the StackedRandomGenerator contract). torch's
generators cannot reproduce JAX's threefry bits; tests that compare the two
packages feed both the same numpy noise.
"""

import numpy as np
import torch


def fold_in(seed: int, data: int) -> int:
    """A 63-bit generator seed mixed from (seed, data), for sub-streams such
    as the sampler's per-step churn noise."""
    hi, lo = np.random.SeedSequence([int(seed), int(data)]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) >> 1


def seeded_normal(seeds, shape, device="cpu", dtype=torch.float32, data: int = 0):
    """[len(seeds), *shape] ~ N(0, 1); row i is a pure function of
    (seeds[i], data) and the device's generator."""
    rows = []
    for s in seeds:
        gen = torch.Generator(device=device).manual_seed(fold_in(s, data))
        rows.append(torch.randn(tuple(shape), generator=gen, device=device, dtype=dtype))
    return torch.stack(rows)
