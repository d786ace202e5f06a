"""The pixel norm's `eps` through the port's three attention entries over raw
rows (`attention_from_raw`, `self_attention_from_packed`, `xattn_from_packed`)
against the JAX package's, at eps = 1e-3 (the default is 1e-4): outputs and
gradients on the same numpy inputs, CPU, fp32.

Inputs. Every D-vector is scaled by 10^u, u uniform in [-3.5, 0.5], so many
rows have r = ||x|| / sqrt(D) near eps and the norm's result depends on it;
each test also checks that the default eps would miss the reference by far
more than the tolerance.

Tolerance: atol 2e-4, that of tests/test_torch_flash_bwd.py (the same sums in
another order; near r ~ eps a gradient is ~1e3 times its cotangent)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.kernels import attention as jattention
from vivid_tpu_torch.kernels import attention

torch.set_num_threads(1)

ATOL = 2e-4
EPS = 1e-3


def _raw(*shape, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape) * 10.0 ** rs.uniform(-3.5, 0.5, shape[:-1] + (1,))
    return x.astype(np.float32)


def _packed(b, s, parts, h, d, seed):
    # [B, S, parts*H*D] part-major; the norm is over each head's D-vector.
    return _raw(b, s, parts * h, d, seed=seed).reshape(b, s, parts * h * d)


def _hold(port_fn, jax_fn, arrays, g):
    """Output and gradients of port_fn(*tensors) against jax.vjp(jax_fn) at
    EPS; returns the port's output at the default eps."""
    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = port_fn(*leaves, eps=EPS)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for a, w in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    default = port_fn(*(t.detach() for t in leaves)).numpy()
    assert np.abs(default - np.asarray(want)).max() > 10 * ATOL, "eps does not matter here"


@pytest.mark.parametrize("sk,with_bias,zs", [(64, False, 0), (48, True, 0), (64, False, 16)])
def test_attention_from_raw_takes_eps(sk, with_bias, zs):
    b, h, sq, d = 2, 2, 32, 16
    arrays = [_raw(b, h, sq, d, seed=1), _raw(b, h, sk, d, seed=2), _raw(b, h, sk, d, seed=3)]
    if with_bias:
        arrays.append(0.5 * np.random.RandomState(4).randn(b, h, sq, sk).astype(np.float32))
    g = np.random.RandomState(5).randn(b, h, sq, d).astype(np.float32)

    def port(q, k, v, bias=None, eps=1e-4):
        return attention.attention_from_raw(q, k, v, bias=bias, zero_sink=zs, eps=eps)

    def ref(q, k, v, bias=None):
        return jattention.attention_from_raw(q, k, v, bias=bias, zero_sink=zs, eps=EPS)

    _hold(port, ref, arrays, g)


@pytest.mark.parametrize("s,zs", [(64, 0), (40, 8)])
def test_self_attention_from_packed_takes_eps(s, zs):
    b, h, d = 2, 2, 16
    qkv = _packed(b, s, 3, h, d, seed=6)
    g = np.random.RandomState(7).randn(b, s, h * d).astype(np.float32)

    def port(qkv, eps=1e-4):
        return attention.self_attention_from_packed(qkv, h, zero_sink=zs, eps=eps)

    def ref(qkv):
        return jattention.self_attention_from_packed(qkv, h, zero_sink=zs, eps=EPS)

    _hold(port, ref, [qkv], g)


@pytest.mark.parametrize("sfs,with_bias", [((64,), False), ((32, 48), False), ((32, 48), True)])
def test_xattn_from_packed_takes_eps(sfs, with_bias):
    b, s, h, d = 2, 32, 2, 16
    arrays = [_packed(b, s, 3, h, d, seed=8)]
    arrays += [_packed(b, sf, 2, h, d, seed=9 + i) for i, sf in enumerate(sfs)]
    n = len(sfs)
    if with_bias:
        arrays += [0.5 * np.random.RandomState(20 + i).randn(b, h, s, sf).astype(np.float32)
                   for i, sf in enumerate(sfs)]
    g = np.random.RandomState(11).randn(b, s, h * d).astype(np.float32)

    def port(qkv, *rest, eps=1e-4):
        return attention.xattn_from_packed(qkv, rest[:n], h, biases=rest[n:], eps=eps)

    def ref(qkv, *rest):
        return jattention.xattn_from_packed(qkv, rest[:n], h, biases=rest[n:], eps=EPS)

    _hold(port, ref, arrays, g)
