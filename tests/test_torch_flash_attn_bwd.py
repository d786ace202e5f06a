"""The plain versions of the port's big-S flash attention kernels (K8: the
forward that returns the row log-sum-exp, and the backward for dq, dk, dv and
the bias) against the JAX package: `reference_attention` and its `jax.vjp`,
and the no-max wrappers `_flash_nomax_call` / `_flash_nomax_biased_call` run
in Pallas interpret mode with their composite backward. Then the
differentiable dispatch at long sequences (CPU, tiny shapes; the threshold is
patched down). The CUDA kernels run only on a card: chip_smoke.py compares
them with these plain versions there.

Tolerances. fp32 inputs: 1e-5 relative L2 (the same function, sums in another
order). bf16 inputs: the forward 1e-2 absolute (one bf16 ulp of an output of
magnitude 1); a gradient 3e-2 of the largest reference element, the limit the
JAX package's own test of these wrappers uses, since P and dS are rounded to
bf16 before the second products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.kernels import attention as jattention
from vivid_tpu.kernels.attention import reference_attention
from vivid_tpu_torch.kernels import attention, flash

from test_torch_flash_nomax import _packed, _qkv

torch.set_num_threads(1)

FP32_REL_L2 = 1e-5
BF16_FWD_ATOL = 1e-2
BF16_GRAD_REL_MAX = 3e-2


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _case(shape, biased, seed):
    b, h, s, sk, d = shape
    q, k, v = _qkv(b, h, s, sk, d, seed=seed)
    rng = np.random.RandomState(seed + 50)
    g = rng.randn(b, h, s, d).astype(np.float32)
    # The epipolar form: bounded, with an offset that breaks the sqrt(D) bound.
    bias = ((3.0 / (1.0 + np.exp(-rng.randn(b, h, s, sk))) + 2.5).astype(np.float32)
            if biased else None)
    return q, k, v, bias, g


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


SHAPES = [(1, 2, 256, 512, 32), (2, 1, 256, 256, 64), (2, 3, 100, 333, 32)]


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_ref_matches_reference_attention(shape, biased):
    """fp32: the output, and lse against log-sum-exp of the same logits."""
    q, k, v, bias, _ = _case(shape, biased, 0)
    want = reference_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               None if bias is None else jnp.asarray(bias))
    logits = np.einsum("bhqd,bhkd->bhqk", q, k, dtype=np.float64) / np.sqrt(shape[-1])
    if biased:
        logits = logits + bias
    m = logits.max(-1)
    want_lse = m + np.log(np.exp(logits - m[..., None]).sum(-1))
    out, lse = flash.flash_attention(_t(q), _t(k), _t(v), _t(bias))
    assert out.shape == q.shape and lse.shape == q.shape[:3] and lse.dtype == torch.float32
    assert _rel_l2(out.numpy(), want) <= FP32_REL_L2
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_ref_matches_jax_vjp_of_reference_attention(shape, biased, monkeypatch):
    """fp32: (dq, dk, dv, dbias) against jax.vjp; walking the query rows in
    chunks of 7 must give what one chunk gives."""
    q, k, v, bias, g = _case(shape, biased, 1)
    args = [jnp.asarray(a) for a in (q, k, v)] + ([jnp.asarray(bias)] if biased else [])
    want = jax.vjp(reference_attention, *args)[1](jnp.asarray(g))
    tq, tk, tv, tb, tg = _t(q), _t(k), _t(v), _t(bias), _t(g)
    out, lse = flash.flash_attention(tq, tk, tv, tb)
    whole = flash.flash_attention_bwd(tq, tk, tv, tb, out, lse, tg)
    b, h, _, sk, _ = shape
    monkeypatch.setattr(flash, "REF_CHUNK_ELEMS", 7 * b * h * sk)
    out_c, lse_c = flash.flash_attention(tq, tk, tv, tb)
    chunked = flash.flash_attention_bwd(tq, tk, tv, tb, out_c, lse_c, tg)
    assert (whole[3] is None) == (chunked[3] is None) == (not biased)
    for name, a, c, w in zip(("dq", "dk", "dv", "dbias"), whole, chunked, want):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        assert _rel_l2(a.numpy(), w) <= FP32_REL_L2, name
        assert _rel_l2(c.numpy(), a.numpy()) <= 1e-6, name


@pytest.mark.parametrize("biased", [False, True])
def test_bf16_refs_match_nomax_wrappers_in_interpret_mode(biased, monkeypatch):
    """bf16: the JAX package's no-max forward (Pallas, interpret mode) with
    its composite backward, against the port's K6 plain forward and K8 plain
    backward on the same bf16 inputs."""
    monkeypatch.setenv("VIVID_PALLAS_INTERPRET", "1")
    q, k, v, bias, g = _case((1, 2, 256, 512, 32), biased, 3)
    if biased:
        bias = (0.5 * np.random.RandomState(9).randn(*bias.shape)).astype(np.float32)
    call = jattention._flash_nomax_biased_call if biased else jattention._flash_nomax_call
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    if biased:
        jargs.append(jnp.asarray(bias))
    want_out, vjp = jax.vjp(call, *jargs)
    want = vjp(jnp.asarray(g).astype(jnp.bfloat16))

    bf = torch.bfloat16
    tq, tk, tv, tg = _t(q, bf), _t(k, bf), _t(v, bf), _t(g, bf)
    tb = _t(bias)
    got_out = flash.flash_nomax(tq, tk, tv, tb)
    out, lse = flash.flash_attention(tq, tk, tv, tb)
    assert out.dtype == bf
    for o in (got_out, out):
        np.testing.assert_allclose(o.float().numpy(), np.asarray(want_out, np.float32),
                                   atol=BF16_FWD_ATOL, rtol=0)
    got = flash.flash_attention_bwd(tq, tk, tv, tb, out, lse, tg)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        w = np.asarray(w, np.float32)
        assert a.dtype == (torch.float32 if name == "dbias" else bf), name
        assert np.abs(a.float().numpy() - w).max() <= BF16_GRAD_REL_MAX * np.abs(w).max(), name


def test_k8_forward_is_exact_where_the_nomax_bound_fails():
    """Unnormalised rows: logits far above sqrt(D). The running max keeps K8
    finite and right (1e-4: a logit of some hundreds carries an fp32 rounding
    of some 1e-5 into its exponential); the no-max forward's contract does not
    cover them."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(1, 1, 40, 32).astype(np.float32) * s for s in (10.0, 10.0, 1.0))
    want = reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = flash.flash_attention(_t(q), _t(k), _t(v))
    assert float(lse.max()) > 88.0            # exp of it overflows fp32
    assert _rel_l2(out.numpy(), want) <= 1e-4
    assert not bool(torch.isfinite(flash.flash_nomax(_t(q), _t(k), _t(v))).all())


def test_cpu_takes_plain_versions_and_counts_nothing():
    q, k, v, bias, g = (_t(a) for a in _case((1, 2, 64, 96, 32), True, 5))
    before = dict(flash.launches)
    out, lse = flash.flash_attention(q, k, v, bias)
    want_out, want_lse = flash.flash_attention_ref(q, k, v, bias)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    got = flash.flash_attention_bwd(q, k, v, bias, out, lse, g)
    for a, w in zip(got, flash.flash_attention_bwd_ref(q, k, v, bias, out, lse, g)):
        assert torch.equal(a, w)
    assert flash.launches == before
    assert {"flash_attention", "flash_attention_bwd"} <= set(before)


@pytest.mark.parametrize("entry", ["fwd", "bwd", "autograd"])
@pytest.mark.parametrize("shape,match", [
    ((1, 2, 64, 32), "must be on"),              # not a CUDA tensor
    ((1, 2, 64, 16), "D 32 or 64"),
])
def test_off_the_cpu_never_takes_the_plain_version(entry, shape, match):
    q = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(shape[:3], dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match=match):
        if entry == "fwd":
            flash.flash_attention(q, q, q)
        elif entry == "bwd":
            flash.flash_attention_bwd(q, q, q, None, q, lse, q)
        else:
            flash.nomax_attention(q.requires_grad_(), q, q)


# ---- the dispatch -----------------------------------------------------------

@pytest.mark.parametrize("n_src,biased", [(0, False), (1, False), (2, False), (2, True)])
def test_dispatch_gradient_matches_the_packed_routes(n_src, biased, monkeypatch):
    """The same packed input through the big-S route (threshold patched down
    to S = 64) and through the packed route: equal outputs and equal gradients
    for qkv, every cross source and every bias (fp32, relative L2 1e-5)."""
    b, s, sf, h, d = 2, 64, 96, 2, 32
    rng = np.random.RandomState(30)
    arrays = [_packed(b, s, 3, h, d, 0)] + [_packed(b, sf, 2, h, d, 1 + i) for i in range(n_src)]
    if biased:
        arrays += [rng.randn(b, h, s, sf).astype(np.float32) for _ in range(n_src)]
    g = torch.from_numpy(rng.randn(b, s, h * d).astype(np.float32))

    def run(threshold):
        monkeypatch.setattr(attention, "NOMAX_MIN_SQ", threshold)
        leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
        qkv, feats, biases = leaves[0], leaves[1:1 + n_src], leaves[1 + n_src:]
        if n_src:
            out = attention.xattn_from_packed(qkv, feats, h, biases=biases)
        else:
            out = attention.self_attention_from_packed(qkv, h)
        return out, torch.autograd.grad(out, leaves, g)

    calls = []
    real = flash.flash_nomax
    monkeypatch.setattr(flash, "flash_nomax", lambda *a: calls.append(1) or real(*a))
    want_out, want = run(4096)
    assert not calls
    got_out, got = run(64)
    assert len(calls) == 1
    assert _rel_l2(got_out.detach().numpy(), want_out.detach().numpy()) <= FP32_REL_L2
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert _rel_l2(a.numpy(), w.numpy()) <= FP32_REL_L2


def test_nomax_autograd_function_runs_k6_forward_and_k8_backward(monkeypatch):
    """The schedule off the CPU, with the launchers replaced by recording
    plain versions: forward K6 alone; backward K8 forward on the saved inputs,
    then K8 backward fed K8's own output and statistics. The gradients equal
    ordinary autograd through the plain forward."""
    q, k, v, bias, g = (_t(a) for a in _case((1, 2, 64, 96, 32), True, 6))
    log = []

    def k6(*a):
        log.append("k6")
        return flash.flash_nomax_ref(*a)

    def k8(*a):
        log.append("k8_fwd")
        return flash.flash_attention_ref(*a)

    def k8_bwd(q_, k_, v_, b_, out, lse, g_):
        want_out, want_lse = flash.flash_attention_ref(q_, k_, v_, b_)
        assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
        log.append("k8_bwd")
        return flash.flash_attention_bwd_ref(q_, k_, v_, b_, out, lse, g_)

    monkeypatch.setattr(flash, "flash_nomax", k6)
    monkeypatch.setattr(flash, "flash_attention", k8)
    monkeypatch.setattr(flash, "flash_attention_bwd", k8_bwd)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = flash._NomaxAttention.apply(*leaves)
    assert log == ["k6"]
    got = torch.autograd.grad(out, leaves, g)
    assert log == ["k6", "k8_fwd", "k8_bwd"]
    plain = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    want = torch.autograd.grad(flash.flash_nomax_ref(*plain), plain, g)
    for a, w in zip(got, want):
        assert _rel_l2(a.numpy(), w.numpy()) <= FP32_REL_L2
