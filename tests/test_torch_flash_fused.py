"""The plain version of the port's [B, H, S, D] forward with the norm and the
sink inside (K5 flash_fused) against the JAX package's Pallas kernel run in
interpret mode, and the [B, H, S, D] entries (`attention_from_raw`,
`fused_attention`, `reference_attention`), outputs and gradients, against the
JAX package's composites; the same numpy inputs, CPU, tiny shapes. The CUDA
kernel itself runs only on a card: chip_smoke.py compares it with this plain
version there.

Tolerances: fp32 3e-5 absolute for outputs (tests/test_flash_fused.py's own:
sums in another order) and 2e-5 for gradients (its backward tests'); bf16
1e-2 absolute, a little over one bf16 ulp of an output of magnitude 1 (both
sides round the normalised rows and p to bf16 at the same places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.kernels import attention as jattention
from vivid_tpu.kernels.flash import flash_fused as j_fused
from vivid_tpu_torch.kernels import attention, flash

torch.set_num_threads(1)

ATOL = {"float32": 3e-5, "bfloat16": 1e-2}
GRAD_ATOL = 2e-5


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _qkv(b, h, sq, sk, d, seed=0):
    return (_x(b, h, sq, d, seed=seed), _x(b, h, sk, d, seed=seed + 1),
            _x(b, h, sk, d, seed=seed + 2))


# tests/test_flash_fused.py CASES, and one in bf16.
@pytest.mark.parametrize("shape,with_bias,eps,zs,dtype", [
    ((1, 2, 256, 256), False, None, 0, "float32"),
    ((1, 2, 256, 768), True, 1e-4, 0, "float32"),
    ((2, 1, 256, 256), False, 1e-4, 512, "float32"),
    ((1, 1, 512, 1024), True, None, 0, "float32"),
    ((1, 1, 512, 1536), False, 1e-4, 2048, "float32"),
    ((1, 2, 256, 768), True, 1e-4, 0, "bfloat16"),
])
def test_fused_ref_matches_pallas(shape, with_bias, eps, zs, dtype):
    b, h, sq, sk = shape
    q, k, v = _qkv(b, h, sq, sk, 64)
    bias = 0.3 * _x(b, h, sq, sk, seed=3) if with_bias else None
    want = j_fused(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                   None if bias is None else jnp.asarray(bias), norm_eps=eps, zero_sink=zs,
                   block_q=256, block_k=256, interpret=True)
    got = flash.flash_fused(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
                            None if bias is None else torch.from_numpy(bias), eps, zs)
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,with_bias,eps,zs", [
    # the edges of the card kernel's tiles: 192 query rows a block, 128 keys a stage
    ((1, 2, 191, 129, 32), False, None, 0),
    ((1, 2, 191, 129, 32), True, 1e-4, 0),
    ((1, 1, 193, 127, 64), False, 1e-4, 0),
    ((1, 1, 193, 127, 64), True, None, 0),
    ((1, 1, 193, 129, 32), True, 1e-4, 50),   # bias and sink together
    ((1, 2, 191, 127, 64), False, 1e-4, 300),
])
def test_fused_ref_tile_edges_match_pallas(shape, with_bias, eps, zs, dtype):
    """Sq one short of or one past a block's rows of the CUDA kernel, Sk one
    past or one short of a stage, d 32 and 64, with and without the norm, the
    bias and the sink: the Pallas kernel takes each length as one block, in
    interpret mode."""
    b, h, sq, sk, d = shape
    q, k, v = _qkv(b, h, sq, sk, d, seed=20)
    bias = 0.3 * _x(b, h, sq, sk, seed=23) if with_bias else None
    if eps is None:   # rows the caller has normalised
        q, k, v = (x / (1e-4 + np.linalg.norm(x, axis=-1, keepdims=True) / np.sqrt(d))
                   for x in (q, k, v))
    want = j_fused(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                   None if bias is None else jnp.asarray(bias), norm_eps=eps, zero_sink=zs,
                   interpret=True)
    got = flash.flash_fused(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
                            None if bias is None else torch.from_numpy(bias), eps, zs)
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("d,with_bias,zs", [(32, False, 0), (64, True, 0), (32, True, 40),
                                            (64, False, 300)])
def test_fused_ref_of_the_prepass_rows_is_the_norm_inside(d, with_bias, zs):
    """The card kernel normalises in a pre-pass and then takes the rows as
    normalised: on bf16 inputs that gives the same bits as the plain version
    with the norm inside, and the pre-pass's plain version is `_rms_norm`."""
    b, h, sq, sk = 2, 2, 37, 70
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(b, h, sq, sk, d, seed=30))
    bias = torch.from_numpy(_x(b, h, sq, sk, seed=33)) if with_bias else None
    rows = flash.flash_fused_norm(q, k, v, 1e-4)
    for got, x in zip(rows, (q, k, v)):
        assert torch.equal(got, flash._rms_norm(x)) and got.dtype == torch.bfloat16
    assert torch.equal(flash.flash_fused_ref(*rows, bias, None, zs),
                       flash.flash_fused_ref(q, k, v, bias, 1e-4, zs))


def test_fused_ref_ragged_and_chunked(monkeypatch):
    """Lengths no block divides (the TPU kernel refuses them), bias and sink
    together (the kernel takes both), against the sink as zero key columns;
    walking the query rows in chunks of 7 must give what one chunk gives."""
    b, h, sq, sk, d, zs = 2, 3, 100, 333, 32, 50
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, h, sq, sk, d, seed=4))
    bias = torch.from_numpy(_x(b, h, sq, sk, seed=8))
    whole = flash.flash_fused_ref(q, k, v, bias, 1e-4, zs)
    zeros = torch.zeros(b, h, zs, d)
    want = flash.flash_fused_ref(q, torch.cat([k, zeros], 2), torch.cat([v, zeros], 2),
                                 torch.cat([bias, torch.zeros(b, h, sq, zs)], 3), 1e-4, 0)
    np.testing.assert_allclose(whole.numpy(), want.numpy(), atol=1e-6, rtol=0)
    monkeypatch.setattr(flash, "REF_CHUNK_ELEMS", 7 * b * h * sk)
    np.testing.assert_allclose(flash.flash_fused_ref(q, k, v, bias, 1e-4, zs).numpy(),
                               whole.numpy(), atol=1e-6, rtol=0)


def test_fused_cpu_takes_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 64, 96, 32))
    before = dict(flash.launches)
    torch.testing.assert_close(flash.flash_fused(q, k, v, norm_eps=1e-4, zero_sink=3),
                               flash.flash_fused_ref(q, k, v, None, 1e-4, 3))
    attention.attention_from_raw(q, k, v)
    assert flash.launches == before and before["flash_fused"] == 0


@pytest.mark.parametrize("shape,match", [
    ((1, 2, 64, 32), "must be on"),              # not a CUDA tensor
    ((1, 2, 64, 16), "D 32 or 64"),
])
def test_fused_off_the_cpu_never_takes_the_plain_version(shape, match):
    q = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=match):
        flash.flash_fused(q, q, q, norm_eps=1e-4)
    with pytest.raises(ValueError, match=match):
        attention.attention_from_raw(q, q, q)


def test_fused_norm_off_the_cpu_never_takes_the_plain_version():
    q = torch.empty(1, 2, 64, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="must be on"):
        flash.flash_fused_norm(q, q, q)


def test_fused_info_needs_a_card(monkeypatch):
    """What K5's forward was built with comes from the built library alone: a
    head dim the kernel lacks raises first, and with no card the call raises
    before it builds or loads anything."""
    def no_library():
        raise AssertionError("flash_fused_info reached the library")

    monkeypatch.setattr(flash.build, "library", no_library)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="32 or 64"):
        flash.flash_fused_info(16)
    for d in (32, 64):
        for biased in (False, True):
            with pytest.raises(RuntimeError, match="CUDA card"):
                flash.flash_fused_info(d, biased)


# ---- the entries ------------------------------------------------------------

def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _hold(got, grads, want, want_grads, atol=ATOL["float32"]):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)
    assert len(grads) == len(want_grads)
    for a, w in zip(grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("sq,sk,with_bias,zs", [
    (64, 192, False, 0),
    (64, 192, True, 0),
    (64, 64, False, 128),
    (256, 320, False, 0),       # the backward's composite goes through the K8 entry
])
def test_attention_from_raw_matches_jax(sq, sk, with_bias, zs):
    """Output (K5's plain version forward) and gradients (the composite's)
    against the JAX package's unfused composite and its jax.vjp."""
    b, h, d = 2, 2, 16
    arrays = list(_qkv(b, h, sq, sk, d, seed=5))
    if with_bias:
        arrays.append(0.5 * _x(b, h, sq, sk, seed=9))
    g = _x(b, h, sq, d, seed=10)

    def composite(q, k, v, bias=None):
        return jattention._xla_attention_from_raw(q, k, v, bias, zs)

    want, vjp = jax.vjp(composite, *(jnp.asarray(a) for a in arrays))
    leaves = _leaves(arrays)
    got = attention.attention_from_raw(*leaves[:3], bias=leaves[3] if with_bias else None,
                                       zero_sink=zs)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    _hold(got, grads, want, vjp(jnp.asarray(g)))


def test_attention_from_raw_refuses_bias_with_sink():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8, 16))
    with pytest.raises(ValueError, match="mutually exclusive"):
        attention.attention_from_raw(q, k, v, bias=torch.zeros(1, 1, 8, 8), zero_sink=4)
    with pytest.raises(AssertionError):
        jattention.attention_from_raw(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                      bias=jnp.zeros((1, 1, 8, 8)), zero_sink=4)


@pytest.mark.parametrize("sq,sk,with_bias,route", [
    (32, 96, True, "reference"),
    (256, 320, False, "flash_attention"),
    (256, 320, True, "flash_attention"),
    (64, 96, True, "flash_nomax"),
])
def test_fused_attention_matches_reference_attention(sq, sk, with_bias, route, monkeypatch):
    """Each route of the dispatch, output and gradients, against the JAX
    package's einsum attention and its jax.vjp; the no-max route with the
    threshold brought down to 64 queries."""
    calls = []
    for name in ("flash_nomax", "flash_attention"):
        real = getattr(flash, name)
        monkeypatch.setattr(flash, name, lambda *a, name=name, real=real: (
            calls.append(name), real(*a))[1])
    if route == "flash_nomax":
        monkeypatch.setattr(attention, "NOMAX_MIN_SQ", 64)
    b, h, d = 1, 2, 16
    q, k, v = _qkv(b, h, sq, sk, d, seed=6)
    norm = lambda x: x / (1e-4 + np.linalg.norm(x, axis=-1, keepdims=True) / np.sqrt(d))
    arrays = [norm(q), norm(k), v] + ([0.5 * _x(b, h, sq, sk, seed=11)] if with_bias else [])
    g = _x(b, h, sq, d, seed=12)
    want, vjp = jax.vjp(jattention.reference_attention, *(jnp.asarray(a) for a in arrays))
    leaves = _leaves(arrays)
    got = attention.fused_attention(*leaves)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    # The no-max route's backward runs K8's forward for the row statistics.
    assert calls == {"reference": [], "flash_attention": ["flash_attention"],
                     "flash_nomax": ["flash_nomax", "flash_attention"]}[route]
    _hold(got, grads, want, vjp(jnp.asarray(g)))
    ref = attention.reference_attention(*(t.detach() for t in leaves))
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=ATOL["float32"], rtol=0)


def test_fused_attention_thresholds_are_the_jax_packages():
    """256 queries and keys for the flash kernels (`_use_pallas`), 4096 queries
    for the no-max kernel."""
    assert attention.FLASH_MIN_S == 256 and attention.NOMAX_MIN_SQ == jattention._NOMAX_MIN_SQ


def test_stock_attention_off_the_cpu_raises_under_autograd():
    q = torch.empty(1, 2, 256, 32, dtype=torch.bfloat16, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="must be on"):
        attention.fused_attention(q, q, q)
