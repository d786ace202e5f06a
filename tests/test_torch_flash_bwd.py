"""The plain versions of the port's backward attention kernels (K3
flash_fused_packed_bwd, K4 flash_fused_packed_xattn_bwd) against the JAX
package's Pallas backward kernels run in interpret mode, on the same numpy
inputs, and the two autograd functions against plain autograd (CPU). The
CUDA kernels themselves run only on a card: chip_smoke.py compares them with
these plain versions there.

Tolerances. fp32: atol 2e-4, as tests/test_flash_fused.py holds the Pallas
kernels to their XLA composite (sums of up to 2048 terms in another order).
bf16: the Pallas kernel rounds q', k', v', p and dS to bf16 before each
product and the plain version computes in fp32 from the same bf16 inputs, so
each gradient is held to a relative L2 of 2e-2 (a handful of 2^-9 roundings
per term, and the output's own)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.kernels.flash import flash_fused_packed_bwd as j_bwd
from vivid_tpu.kernels.flash import flash_fused_packed_xattn_bwd as j_xattn_bwd
from vivid_tpu_torch.kernels import attention, flash

torch.set_num_threads(1)

ATOL = 2e-4
BF16_REL_L2 = 2e-2


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _hold(got, want, bf16, what):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want.astype(jnp.float32), np.float64)
    assert got.shape == want.shape, what
    if bf16:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_REL_L2, f"{what}: relative L2 {err:.3e}"
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=what)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,sink", [((2, 256, 2, 64), 0),
                                        ((1, 512, 3, 32), 0),
                                        ((2, 256, 2, 64), 512),
                                        ((1, 1024, 2, 64), 2048),
                                        ((1, 1024, 8, 16), 64)])
def test_packed_bwd_ref_matches_pallas(shape, sink, bf16):
    b, s, h, d = shape
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    qkv, g = _x(b, s, 3 * h * d, seed=11), _x(b, s, h * d, seed=12)
    want = j_bwd(jnp.asarray(qkv, jdt), jnp.asarray(g, jdt), h, zero_sink=sink,
                 interpret=True)
    got = flash.flash_fused_packed_bwd(torch.from_numpy(qkv).to(tdt),
                                       torch.from_numpy(g).to(tdt), h, sink)
    assert got.dtype == tdt
    _hold(got, want, bf16, "dqkv")


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,sf,h,d,n,biased", [(2, 256, 256, 2, 64, 2, False),
                                                 (1, 256, 512, 2, 64, 2, True),
                                                 (1, 512, 256, 3, 32, 1, True),
                                                 (1, 512, 512, 8, 16, 2, True)])
def test_packed_xattn_bwd_ref_matches_pallas(b, s, sf, h, d, n, biased, bf16):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    qkv, g = _x(b, s, 3 * h * d, seed=20), _x(b, s, h * d, seed=21)
    feats = [_x(b, sf, 2 * h * d, seed=22 + i) for i in range(n)]
    biases = [0.5 * _x(b, h, s, sf, seed=30 + i) for i in range(n)] if biased else []
    wq, wf, wb = j_xattn_bwd(jnp.asarray(qkv, jdt), tuple(jnp.asarray(f, jdt) for f in feats),
                             jnp.asarray(g, jdt), h,
                             biases=tuple(jnp.asarray(x) for x in biases), interpret=True)
    gq, gf, gb = flash.flash_fused_packed_xattn_bwd(
        torch.from_numpy(qkv).to(tdt), [torch.from_numpy(f).to(tdt) for f in feats],
        torch.from_numpy(g).to(tdt), h, [torch.from_numpy(x) for x in biases])
    assert len(gf) == len(wf) == n and len(gb) == len(wb) == len(biases)
    assert gq.dtype == tdt and all(t.dtype == tdt for t in gf)
    assert all(t.dtype == torch.float32 for t in gb)
    _hold(gq, wq, bf16, "dqkv")
    for i in range(n):
        _hold(gf[i], wf[i], bf16, f"dfeats[{i}]")
    for i in range(len(biases)):
        _hold(gb[i], wb[i], bf16, f"dbias[{i}]")


@pytest.mark.parametrize("sink", [0, 64])
def test_self_attention_function_matches_plain_autograd(sink):
    qkv = torch.from_numpy(_x(2, 32, 3 * 2 * 16)).requires_grad_()
    g = torch.from_numpy(_x(2, 32, 2 * 16, seed=1))
    before = dict(flash.launches)
    got = torch.autograd.grad(attention.self_attention_from_packed(qkv, 2, zero_sink=sink),
                              qkv, g)[0]
    want = torch.autograd.grad(flash.flash_fused_packed_ref(qkv, 2, sink), qkv, g)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert flash.launches == before   # CPU tensors launch nothing


@pytest.mark.parametrize("biased", [False, True])
def test_xattn_function_matches_plain_autograd(biased):
    h, d, s = 2, 16, 32
    qkv = torch.from_numpy(_x(2, s, 3 * h * d)).requires_grad_()
    feats = [torch.from_numpy(_x(2, 48, 2 * h * d, seed=1 + i)).requires_grad_()
             for i in range(2)]
    biases = [torch.from_numpy(_x(2, h, s, 48, seed=5 + i)).requires_grad_()
              for i in range(2)] if biased else []
    g = torch.from_numpy(_x(2, s, h * d, seed=9))
    leaves = [qkv, *feats, *biases]
    got = torch.autograd.grad(attention.xattn_from_packed(qkv, feats, h, biases), leaves, g)
    want = torch.autograd.grad(flash.flash_fused_packed_xattn_ref(qkv, feats, h, biases),
                               leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_zero_rows_give_finite_gradients():
    """r = 0: a zero q, k or v row normalises to zero, and its gradient is
    dy / eps, finite (the guard of the norm's VJP)."""
    h, d, s = 2, 16, 32
    qkv = _x(1, s, 3 * h * d)
    qkv[0, 3] = 0.0
    feats = _x(1, s, 2 * h * d, seed=1)
    feats[0, 5] = 0.0
    g = torch.from_numpy(_x(1, s, h * d, seed=2))
    dqkv = flash.flash_fused_packed_bwd(torch.from_numpy(qkv), g, h, zero_sink=8)
    assert bool(torch.isfinite(dqkv).all())
    dq, (df,), _ = flash.flash_fused_packed_xattn_bwd(
        torch.from_numpy(qkv), [torch.from_numpy(feats)], g, h)
    assert bool(torch.isfinite(dq).all()) and bool(torch.isfinite(df).all())
    want = np.asarray(j_bwd(jnp.asarray(qkv), jnp.asarray(g.numpy()), h, zero_sink=8,
                            interpret=True))
    # The zero row's gradient is ~1e4 x dy, hence the relative term.
    np.testing.assert_allclose(dqkv.numpy(), want, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("fn,match", [
    (lambda q, g: flash.flash_fused_packed_bwd(q, g, 2), "must be on"),
    (lambda q, g: flash.flash_fused_packed_xattn_bwd(q, [], g, 5), "head dim must be 32 or 64"),
])
def test_backward_wrappers_never_take_the_plain_version_off_the_cpu(fn, match):
    """Off the CPU the backward wrappers launch their kernel or raise (meta
    tensors stand in for a card)."""
    qkv = torch.empty(1, 64, 3 * 2 * 64, dtype=torch.bfloat16, device="meta")
    g = torch.empty(1, 64, 2 * 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=match):
        fn(qkv, g)


def test_packed_bwd_info_needs_a_card(monkeypatch):
    """What K3/K4's kernels were built with comes from the built library
    alone: a head dim the kernels lack raises first, and with no card the
    call raises before it builds or loads anything."""
    def no_library():
        raise AssertionError("flash_packed_bwd_info reached the library")

    monkeypatch.setattr(flash.build, "library", no_library)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="32 or 64"):
        flash.flash_packed_bwd_info(16)
    for d in (32, 64):
        for biased in (False, True):
            with pytest.raises(RuntimeError, match="CUDA card"):
                flash.flash_packed_bwd_info(d, biased)


@pytest.mark.parametrize("b,s,h,lens,dq,dkv", [
    (8, 1024, 4, (), 512, 512),                  # K3 at the 64px model's 32x32
    (8, 1024, 4, (1024, 1024), 512, 1536),       # K4 there: 48 key tiles a head
    (8, 64, 8, (64, 64), 64, 192),               # 8x8: one tile a segment
    (2, 100, 4, (333,), 16, 64),                 # ragged: 2 + 6 key tiles
])
def test_packed_bwd_plan(b, s, h, lens, dq, dkv):
    """The grids of the backward's dq and dk/dv kernels at a shape: a block
    for each 64-row tile, every segment padded to whole tiles, and the waves
    they make at two blocks an SM on 132 SMs."""
    plan = flash.packed_bwd_plan(b, s, h, lens)
    assert (plan["dq"]["blocks"], plan["dkv"]["blocks"]) == (dq, dkv)
    for p in plan.values():
        assert p["waves"] == round(p["blocks"] / (2 * 132), 3)
