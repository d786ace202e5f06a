"""The PyTorch port's magnitude-preserving primitives against
vivid_tpu/nn/mp.py on the same numpy inputs (CPU, fp32, atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.nn import mp as jmp
from vivid_tpu_torch.nn import mp

torch.set_num_threads(1)

ATOL = 1e-5


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("dim", [None, -1])
def test_normalize(dim):
    x = _x(2, 4, 4, 8)
    want = jmp.normalize(jnp.asarray(x), axis=dim)
    got = mp.normalize(torch.from_numpy(x), dim=dim)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_normalize_bf16_divides_in_input_dtype():
    x = _x(3, 64)
    want = np.asarray(jmp.normalize(jnp.asarray(x, jnp.bfloat16), axis=-1).astype(jnp.float32))
    got = mp.normalize(torch.from_numpy(x).bfloat16(), dim=-1).float().numpy()
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0.01)


def test_mp_silu_sum_cat():
    a, b = _x(2, 3, 5, seed=1), _x(2, 3, 7, seed=2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(mp.mp_silu(ta).numpy(), jmp.mp_silu(jnp.asarray(a)), atol=ATOL)
    np.testing.assert_allclose(mp.mp_sum(ta, ta * 0.5, t=0.3).numpy(),
                               jmp.mp_sum(jnp.asarray(a), jnp.asarray(a) * 0.5, t=0.3), atol=ATOL)
    np.testing.assert_allclose(mp.mp_cat(ta, tb, t=0.5).numpy(),
                               jmp.mp_cat(jnp.asarray(a), jnp.asarray(b), t=0.5), atol=ATOL)


@pytest.mark.parametrize("mode", ["keep", "down", "up"])
def test_resample(mode):
    x = _x(2, 8, 8, 3)
    np.testing.assert_allclose(mp.resample(torch.from_numpy(x), mode).numpy(),
                               jmp.resample(jnp.asarray(x), mode), atol=ATOL)


def test_mp_fourier():
    freqs, phases = _x(16, seed=3) * 6.28, np.abs(_x(16, seed=4))
    x = _x(5, seed=5)
    f = mp.MPFourier(16)
    f.freqs.copy_(torch.from_numpy(freqs))
    f.phases.copy_(torch.from_numpy(phases))
    want = jmp.mp_fourier_apply({"freqs": jnp.asarray(freqs), "phases": jnp.asarray(phases)},
                                jnp.asarray(x))
    np.testing.assert_allclose(f(torch.from_numpy(x)).numpy(), want, atol=ATOL)


@pytest.mark.parametrize("kernel,shape,gain", [
    ((3, 3), (2, 6, 6, 5), 1.0),
    ((1, 1), (2, 4, 4, 5), 0.7),
    ((), (3, 5), 1.3),
])
def test_mp_conv(kernel, shape, gain):
    """MPConv (3x3 conv, 1x1 conv, linear) with the reference OIHW /
    [out, in] weights vs mp_conv_apply on the HWIO / [in, out] twin."""
    w_hwio = _x(*kernel, 5, 7, seed=6)
    x = _x(*shape, seed=7)
    want = jmp.mp_conv_apply({"w": jnp.asarray(w_hwio)}, jnp.asarray(x), gain=gain)
    conv = mp.MPConv(5, 7, kernel)
    w = w_hwio.transpose(3, 2, 0, 1) if kernel else w_hwio.T
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
        got = conv(torch.from_numpy(x), gain=gain)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_mp_conv_seeded_init():
    conv = mp.MPConv(4, 6, (3, 3))
    with torch.no_grad():
        conv.reset_parameters(torch.Generator().manual_seed(0))
    assert conv.weight.shape == (6, 4, 3, 3)
    w = conv.normalized_weight(torch.float32, gain=2.0)
    # Norm == gain up to the 1e-4 eps against a filter RMS near 1.
    np.testing.assert_allclose(w.detach().flatten(1).norm(dim=1).numpy(), 2.0, rtol=1e-3)
