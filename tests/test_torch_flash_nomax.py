"""The plain version of the port's big-S no-max attention kernel (K6
flash_nomax) against the JAX package's Pallas kernel run in interpret mode,
and the dispatch that sends long sequences to it (CPU, tiny shapes; its
gradient is held in test_torch_flash_attn_bwd.py). The
CUDA kernel itself runs only on a card: chip_smoke.py compares it with this
plain version there.

Tolerances: fp32 inputs 3e-5 absolute (sums in another order, as in
test_torch_flash.py); bf16 inputs 1e-2 absolute, a little over one bf16 ulp
of an output of magnitude 1 (both sides round q and p to bf16 at the same
places, so most elements agree exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.kernels.attention import reference_attention
from vivid_tpu.kernels.flash import flash_nomax as j_nomax
from vivid_tpu_torch.kernels import attention, flash

torch.set_num_threads(1)

ATOL = {"float32": 3e-5, "bfloat16": 1e-2}


def _rows(*shape, seed=0, normalised=True):
    """d-vectors of very different lengths, pixel-normalised like the
    caller of the kernel normalises them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * np.exp(rng.randn(*shape[:-1], 1))
    if normalised:
        x = x / (1e-4 + np.linalg.norm(x, axis=-1, keepdims=True) / np.sqrt(shape[-1]))
    return x.astype(np.float32)


def _qkv(b, h, s, sk, d, seed=0):
    return (_rows(b, h, s, d, seed=seed), _rows(b, h, sk, d, seed=seed + 1),
            _rows(b, h, sk, d, seed=seed + 2, normalised=False))


def _both(arrays, dtype):
    jt = [jnp.asarray(a).astype(dtype) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jt, tt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,blocks,chains", [
    ((1, 2, 256, 512, 32), (128, 256), 2),
    ((1, 2, 256, 512, 32), (256, 512), 1),
    ((2, 1, 256, 256, 64), (128, 128), 1),
    ((1, 1, 384, 640, 32), (128, 128), 1),
])
def test_nomax_ref_matches_pallas(shape, blocks, chains, dtype):
    jt, tt = _both(_qkv(*shape), dtype)
    want = j_nomax(*jt, block_q=blocks[0], block_k=blocks[1], chains=chains, interpret=True)
    got = flash.flash_nomax(*tt)
    assert got.dtype == tt[2].dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,blocks,chains", [
    ((1, 2, 256, 512, 32), (128, 256), 2),
    ((2, 1, 256, 256, 64), (128, 128), 1),
])
def test_nomax_ref_biased_matches_pallas(shape, blocks, chains, dtype):
    """The bias has the epipolar form: a bounded mix plus an offset that
    breaks the static sqrt(D) bound, so the dynamic shift matters."""
    b, h, s, sk, d = shape
    rng = np.random.RandomState(11)
    bias = (3.0 / (1.0 + np.exp(-rng.randn(b, h, s, sk))) + 2.5).astype(np.float32)
    jt, tt = _both(_qkv(*shape, seed=7), dtype)
    want = j_nomax(*jt, jnp.asarray(bias), block_q=blocks[0], block_k=blocks[1],
                   chains=chains, interpret=True)
    got = flash.flash_nomax(*tt, torch.from_numpy(bias))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("shape", [
    (1, 2, 191, 129, 32),   # the edges of the card kernel's tiles: 192 query rows
    (1, 1, 193, 127, 64),   # a block, 128 keys a stage
])
def test_nomax_ref_tile_edges_match_pallas(shape, biased, dtype):
    """Sq one short of or one past a block's rows of the CUDA kernel, Sk one
    past or one short of a stage: the Pallas kernel takes them as one block
    each, in interpret mode."""
    b, h, s, sk, d = shape
    bias = (np.random.RandomState(13).randn(b, h, s, sk).astype(np.float32)
            if biased else None)
    jt, tt = _both(_qkv(*shape, seed=17), dtype)
    want = j_nomax(*jt, None if bias is None else jnp.asarray(bias), interpret=True)
    got = flash.flash_nomax(*tt, None if bias is None else torch.from_numpy(bias))
    assert got.dtype == tt[2].dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("biased", [False, True])
def test_nomax_ref_ragged_matches_reference_attention(biased, monkeypatch):
    """Lengths no block divides (the TPU kernel refuses them), against the
    JAX package's einsum attention; the plain version walks the query rows in
    chunks of 7 here and must give what one chunk gives."""
    b, h, s, sk, d = 2, 3, 100, 333, 32
    q, k, v = _qkv(b, h, s, sk, d, seed=3)
    bias = np.random.RandomState(5).randn(b, h, s, sk).astype(np.float32) if biased else None
    want = reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if bias is None else jnp.asarray(bias))
    args = [torch.from_numpy(a) for a in (q, k, v)] + [None if bias is None
                                                      else torch.from_numpy(bias)]
    whole = flash.flash_nomax_ref(*args)
    monkeypatch.setattr(flash, "REF_CHUNK_ELEMS", 7 * b * h * sk)
    chunked = flash.flash_nomax_ref(*args)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), atol=ATOL["float32"], rtol=0)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6, rtol=0)


def test_nomax_rounds_q_twice():
    """bf16: the caller's rounding of the normalised q, then the kernel's
    after scaling by 1/sqrt(D). Folding the scale into the logits instead
    gives other bits."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(1, 1, 64, 64, 32, seed=9))
    got = flash.flash_nomax_ref(q, k, v).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / np.sqrt(32)
    folded = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.float())
    assert 0 < (got - folded).abs().max() <= ATOL["bfloat16"]


def test_nomax_cpu_takes_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 64, 96, 32))
    before = dict(flash.launches)
    torch.testing.assert_close(flash.flash_nomax(q, k, v), flash.flash_nomax_ref(q, k, v))
    assert flash.launches == before and "flash_nomax" in before


def test_nomax_info_needs_a_card(monkeypatch):
    """What the kernel was built with comes from the built library alone: a
    head dim the kernel lacks raises first, and with no card the call raises
    before it builds or loads anything."""
    def no_library():
        raise AssertionError("flash_nomax_info reached the library")

    monkeypatch.setattr(flash.build, "library", no_library)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="32 or 64"):
        flash.flash_nomax_info(16)
    for d in (32, 64):
        with pytest.raises(RuntimeError, match="CUDA card"):
            flash.flash_nomax_info(d, biased=True)


@pytest.mark.parametrize("shape,match", [
    ((1, 2, 64, 32), "must be on"),              # not a CUDA tensor
    ((1, 2, 64, 16), "D 32 or 64"),
])
def test_nomax_off_the_cpu_never_takes_the_plain_version(shape, match):
    q = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=match):
        flash.flash_nomax(q, q, q)


# ---- the dispatch -----------------------------------------------------------

@pytest.fixture
def spy(monkeypatch):
    """Threshold down to S = 64; records every call of flash.flash_nomax."""
    calls = []
    real = flash.flash_nomax

    def recorded(q, k, v, bias=None):
        calls.append((tuple(q.shape), tuple(k.shape), None if bias is None else tuple(bias.shape)))
        return real(q, k, v, bias)

    monkeypatch.setattr(attention, "NOMAX_MIN_SQ", 64)
    monkeypatch.setattr(flash, "flash_nomax", recorded)
    return calls


def _packed(b, s, parts, h, d, seed):
    return _rows(b, s, parts * h, d, seed=seed, normalised=False).reshape(b, s, parts * h * d)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("n_src,biased", [(0, False), (1, False), (2, False), (2, True)])
def test_dispatch_takes_nomax_and_matches_packed(spy, n_src, biased, dtype, atol):
    """Above the threshold both entries go through the K6 entry on the
    concatenated segments and agree with the K1/K2 plain versions: to 1e-5
    in fp32 (the same function), to 2e-2 in bf16 (two bf16 ulps: the no-max
    route rounds the scaled q and p once more than the packed plain version)."""
    b, s, sf, h, d = 2, 64, 96, 2, 32
    tdt = getattr(torch, dtype)
    qkv = torch.from_numpy(_packed(b, s, 3, h, d, 0)).to(tdt)
    feats = [torch.from_numpy(_packed(b, sf, 2, h, d, 1 + i)).to(tdt) for i in range(n_src)]
    biases = [torch.from_numpy(np.random.RandomState(20 + i).randn(b, h, s, sf)
                               .astype(np.float32)) for i in range(n_src)] if biased else []
    if n_src:
        got = attention.xattn_from_packed(qkv, feats, h, biases=biases)
        want = flash.flash_fused_packed_xattn_ref(qkv, feats, h, biases)
    else:
        got = attention.self_attention_from_packed(qkv, h)
        want = flash.flash_fused_packed_ref(qkv, h)
    sk = s + n_src * sf
    assert spy == [((b, h, s, d), (b, h, sk, d), (b, h, s, sk) if biased else None)]
    assert got.shape == (b, s, h * d) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=atol, rtol=0)


def test_dispatch_keeps_packed_kernels_below_threshold_and_for_a_sink(spy):
    h, d = 2, 32
    short = torch.from_numpy(_packed(1, 32, 3, h, d, 0))
    long = torch.from_numpy(_packed(1, 64, 3, h, d, 1))
    feats = [torch.from_numpy(_packed(1, 32, 2, h, d, 2))]
    attention.self_attention_from_packed(short, h)
    attention.xattn_from_packed(short, feats, h)
    got = attention.self_attention_from_packed(long, h, zero_sink=128)
    assert spy == []
    torch.testing.assert_close(got, flash.flash_fused_packed_ref(long, h, 128))


def test_dispatch_threshold_is_the_jax_packages():
    from vivid_tpu.kernels.attention import _NOMAX_MIN_SQ
    assert attention.NOMAX_MIN_SQ == _NOMAX_MIN_SQ == 4096


@pytest.mark.parametrize("entry", ["self", "xattn"])
def test_dispatch_raises_under_autograd(spy, entry):
    """Under autograd a tensor that is neither on the CPU nor a CUDA tensor the
    kernels take raises from the launcher: there is no quiet way round the
    kernels to the plain version. On the CPU the same call differentiates
    (tests/test_torch_flash_attn_bwd.py holds the gradient to the packed
    route's)."""
    h, d = 2, 32
    qkv = torch.from_numpy(_packed(1, 64, 3, h, d, 0))
    feats = [torch.from_numpy(_packed(1, 64, 2, h, d, 1))]

    def call(device):
        x = qkv.to(device).requires_grad_()
        if entry == "self":
            return x, attention.self_attention_from_packed(x, h)
        return x, attention.xattn_from_packed(x, [f.to(device) for f in feats], h)

    with pytest.raises(ValueError, match="must be on"):
        call("meta")
    assert len(spy) == 1
    x, out = call("cpu")
    out.sum().backward()
    assert len(spy) == 2 and x.grad.shape == x.shape and bool(x.grad.abs().sum() > 0)
