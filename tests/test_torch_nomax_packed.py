"""The plain version of the port's no-max packed attention kernel (K7
flash_nomax_packed) against the JAX package's Pallas kernel run in interpret
mode, the VIVID_NOMAX_PACKED switch of the packed entries, and a tiny
NVPrecond under the switch in both packages, forward and gradient; the same
numpy inputs, CPU. The CUDA kernel itself runs only on a card: chip_smoke.py
compares it with this plain version there.

Tolerances: fp32 3e-5 absolute (sums in another order, as in
test_torch_flash.py); bf16 1e-2 absolute, a little over one bf16 ulp of an
output of magnitude 1 (both sides fold the scale into q before rounding it
and round p to bf16 at the same places, so most elements agree exactly). The
model: relative L2 1e-4 for D_x and 1e-3 per parameter gradient, as
test_torch_model.py and test_torch_train_step.py hold the packed route."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.kernels import flash as jflash
from vivid_tpu.nn import precond as jprecond
from vivid_tpu_torch.compat.from_jax import from_jax
from vivid_tpu_torch.kernels import attention, flash
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig

from test_torch_model import _params

torch.set_num_threads(1)

ATOL = {"float32": 3e-5, "bfloat16": 1e-2}


def _packed(b, s, parts, h, d, seed):
    """Packed rows whose d-vectors have very different lengths, so the norm
    inside matters."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, parts * h, d) * np.exp(rng.randn(b, s, parts * h, 1))
    return x.reshape(b, s, parts * h * d).astype(np.float32)


# tests/test_nomax_packed.py's cases: self, the sink, one and two sources;
# then two sources of different lengths, at d 32 and at d 64.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,d,sink,feat_lens", [
    (1, 128, 4, 32, 0, ()),
    (2, 128, 4, 32, 256, ()),
    (1, 256, 2, 64, 0, ()),
    (1, 128, 4, 32, 0, (128, 128)),
    (1, 256, 4, 32, 0, (128,)),
    (2, 128, 2, 64, 0, (128, 128)),
    (1, 128, 4, 32, 0, (256, 128)),
    (2, 128, 2, 64, 0, (128, 384)),
])
def test_nomax_packed_ref_matches_pallas(b, s, h, d, sink, feat_lens, dtype):
    qkv = _packed(b, s, 3, h, d, seed=s + sink)
    feats = [_packed(b, sf, 2, h, d, seed=10 + i) for i, sf in enumerate(feat_lens)]
    want = jflash.flash_nomax_packed(
        jnp.asarray(qkv).astype(dtype), tuple(jnp.asarray(f).astype(dtype) for f in feats), h,
        zero_sink=sink, block_q=128, block_k=128, interpret=True)
    tdt = getattr(torch, dtype)
    got = flash.flash_nomax_packed(torch.from_numpy(qkv).to(tdt),
                                   [torch.from_numpy(f).to(tdt) for f in feats], h, sink)
    assert got.dtype == tdt and got.shape == (b, s, h * d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("s,sfs,sink", [(100, (), 0), (100, (), 200), (100, (77, 100), 0)])
def test_nomax_packed_ref_is_the_packed_kernels_function(s, sfs, sink):
    """Ragged lengths (the TPU kernel refuses them): in fp32 the no-max form
    gives what the forms with a running max give."""
    b, h, d = 2, 3, 32
    qkv = torch.from_numpy(_packed(b, s, 3, h, d, seed=1))
    feats = [torch.from_numpy(_packed(b, sf, 2, h, d, seed=2 + i)) for i, sf in enumerate(sfs)]
    got = flash.flash_nomax_packed_ref(qkv, feats, h, sink)
    want = (flash.flash_fused_packed_xattn_ref(qkv, feats, h) if feats
            else flash.flash_fused_packed_ref(qkv, h, sink))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_nomax_packed_folds_the_scale_into_q():
    """bf16: q is scaled before it is rounded, once. Rounding the normalised
    q first and scaling the logits gives other bits."""
    qkv = torch.from_numpy(_packed(1, 64, 3, 2, 32, seed=3)).bfloat16()
    got = flash.flash_nomax_packed_ref(qkv, (), 2).float()
    other = flash.flash_fused_packed_ref(qkv, 2).float()
    assert 0 < (got - other).abs().max() <= ATOL["bfloat16"]


def test_nomax_packed_cpu_takes_plain_version_and_counts_nothing():
    qkv = torch.from_numpy(_packed(1, 64, 3, 2, 32, seed=0))
    before = dict(flash.launches)
    torch.testing.assert_close(flash.flash_nomax_packed(qkv, (), 2, 5),
                               flash.flash_nomax_packed_ref(qkv, (), 2, 5))
    assert flash.launches == before and before["flash_nomax_packed"] == 0


def test_nomax_packed_info_needs_a_card(monkeypatch):
    """What K7's kernel was built with comes from the built library alone: a
    head dim the kernel lacks raises first, and with no card the call raises
    before it builds or loads anything."""
    def no_library():
        raise AssertionError("flash_nomax_packed_info reached the library")

    monkeypatch.setattr(flash.build, "library", no_library)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="32 or 64"):
        flash.flash_nomax_packed_info(16)
    for d in (32, 64):
        with pytest.raises(RuntimeError, match="CUDA card"):
            flash.flash_nomax_packed_info(d)


@pytest.mark.parametrize("b,s,h,d,lens,rows,blocks", [
    # the 64px model's three shapes with two sources of S keys: q's S rows
    # and k's and v's 3 S keys a head, each segment whole 64-row tiles
    (8, 1024, 4, 64, (1024, 1024), 8 * 4 * (1024 + 2 * 3072) * 64, 512),
    (8, 256, 6, 64, (256, 256), 8 * 6 * (256 + 2 * 768) * 64, 192),
    (8, 64, 8, 64, (64, 64), 8 * 8 * (64 + 2 * 192) * 64, 64),
    # the self form, and ragged segments padded apart: 100 -> 128, 77 -> 128
    (8, 1024, 4, 64, (), 8 * 4 * (1024 + 2 * 1024) * 64, 512),
    (2, 100, 4, 32, (77, 100), 2 * 4 * (100 + 2 * 384) * 32, 16),
])
def test_nomax_packed_scratch_and_grid(b, s, h, d, lens, rows, blocks):
    """K7 runs K1/K2's two launches: the pre-pass's scratch (c q' rows, then
    k' and v' with every segment padded to whole 64-row tiles, one bf16
    allocation) and the forward's grid, a block for each 64-row query tile,
    two blocks an SM on 132 SMs."""
    assert flash.packed_fwd_rows(b, s, h, d, lens) == rows
    assert flash.packed_fwd_plan(b, s, h) == {
        "fwd": dict(blocks=blocks, waves=round(blocks / (2 * 132), 3))}


@pytest.mark.parametrize("shape,heads,feats,match", [
    ((1, 64, 3 * 2 * 64), 2, (), "must be on"),            # not a CUDA tensor
    ((1, 64, 3 * 2 * 16), 2, (), "head dim must be 32 or 64"),
    ((1, 64, 3 * 2 * 64), 2, [(1, 64, 4 * 64)] * 3, "at most 2 cross sources"),
])
def test_nomax_packed_off_the_cpu_never_takes_the_plain_version(shape, heads, feats, match):
    qkv = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    fs = [torch.empty(f, dtype=torch.bfloat16, device="meta") for f in feats]
    with pytest.raises(ValueError, match=match):
        flash.flash_nomax_packed(qkv, fs, heads)


# ---- the switch -------------------------------------------------------------

@pytest.fixture
def spy(monkeypatch):
    """Records which forward each packed entry takes."""
    calls = []
    for name in ("flash_fused_packed", "flash_fused_packed_xattn", "flash_nomax_packed"):
        real = getattr(flash, name)
        monkeypatch.setattr(flash, name, lambda *a, name=name, real=real, **kw: (
            calls.append(name), real(*a, **kw))[1])
    return calls


def _entry_inputs():
    b, s, sf, h, d = 1, 64, 96, 2, 32
    qkv = torch.from_numpy(_packed(b, s, 3, h, d, seed=0))
    feats = [torch.from_numpy(_packed(b, sf, 2, h, d, seed=1 + i)) for i in range(2)]
    biases = [torch.from_numpy(np.random.RandomState(20 + i).randn(b, h, s, sf)
                               .astype(np.float32)) for i in range(2)]
    return qkv, feats, biases, h


def test_switch_is_read_at_call_time_and_a_bias_keeps_the_max(spy, monkeypatch):
    qkv, feats, biases, h = _entry_inputs()

    def calls():
        del spy[:]
        outs = (attention.self_attention_from_packed(qkv, h),
                attention.self_attention_from_packed(qkv, h, zero_sink=128),
                attention.xattn_from_packed(qkv, feats, h),
                attention.xattn_from_packed(qkv, feats, h, biases=biases))
        return list(spy), outs

    monkeypatch.delenv("VIVID_NOMAX_PACKED", raising=False)
    off, want = calls()
    assert off == ["flash_fused_packed"] * 2 + ["flash_fused_packed_xattn"] * 2
    monkeypatch.setenv("VIVID_NOMAX_PACKED", "1")
    on, got = calls()
    assert on == ["flash_nomax_packed"] * 3 + ["flash_fused_packed_xattn"]
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5, rtol=0)
    monkeypatch.setenv("VIVID_NOMAX_PACKED", "0")
    assert calls()[0] == off
    with pytest.raises(ValueError, match="takes no bias"):
        flash.packed_xattn(qkv, feats, h, biases=biases, nomax=True)


def test_switch_keeps_the_backward(monkeypatch):
    """The switch swaps the forward only: the gradients are the packed
    backward's, equal to the last bit (they are computed from the inputs
    alone), and no quiet way leads round the kernels off the CPU."""
    qkv, feats, _, h = _entry_inputs()

    def grads():
        leaves = [t.clone().requires_grad_() for t in (qkv, *feats)]
        out = (attention.self_attention_from_packed(leaves[0], h, zero_sink=32).square().sum()
               + attention.xattn_from_packed(leaves[0], leaves[1:], h).square().sum())
        return torch.autograd.grad(out, leaves)

    monkeypatch.setenv("VIVID_NOMAX_PACKED", "0")
    want = grads()
    monkeypatch.setenv("VIVID_NOMAX_PACKED", "1")
    got = grads()
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="must be on"):
        attention.self_attention_from_packed(qkv.to("meta").requires_grad_(), h)


# ---- a tiny model under the switch, both packages ---------------------------

def test_precond_under_the_switch_matches_jax(monkeypatch):
    """One level at 8x8 with 128 channels and 32 a head: 4 heads, the head
    group the TPU kernel's 128-lane gate asks for, S = 64. D_x and the
    gradient of <D_x, g> by every parameter, with VIVID_NOMAX_PACKED=1 in
    both packages (the JAX side runs its Pallas kernels in interpret mode)."""
    monkeypatch.setenv("VIVID_NOMAX_PACKED", "1")
    monkeypatch.setenv("VIVID_PALLAS_INTERPRET", "1")
    jcalls, tcalls = [], []
    jreal, treal = jflash.flash_nomax_packed, flash.flash_nomax_packed
    monkeypatch.setattr(jflash, "flash_nomax_packed",
                        lambda *a, **kw: (jcalls.append(len(a[1])), jreal(*a, **kw))[1])
    monkeypatch.setattr(flash, "flash_nomax_packed",
                        lambda *a, **kw: (tcalls.append(len(a[1])), treal(*a, **kw))[1])
    jcfg = jprecond.PrecondConfig(
        img_resolution=8, model_channels=128, channel_mult=(1,), num_blocks=1,
        attn_resolutions=(8,), channels_per_head=32, use_bf16=False, remat=False)
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 4)
    rng = np.random.RandomState(4)
    src = rng.randn(1, 2, 8, 8, 3).astype(np.float32)
    dst = rng.randn(1, 8, 8, 3).astype(np.float32)
    geo = rng.randn(1, 2, 20).astype(np.float32)
    sigma = np.array([0.7], np.float32)
    g = rng.randn(1, 8, 8, 3).astype(np.float32)

    def scalar(p):
        out = jprecond.precond_apply(p, jcfg, src, dst, sigma, geo)
        return jnp.sum(out * g), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(scalar, has_aux=True))(params)
    want_grads = {k: v.numpy() for k, v in from_jax(jax.tree.map(np.asarray, want_grads)).items()}

    net = NVPrecond(PrecondConfig(**dataclasses.asdict(jcfg)))
    net.load_state_dict(from_jax(params), strict=True)
    got = net.eval()(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(sigma),
                     torch.from_numpy(geo))
    (got * torch.from_numpy(g)).sum().backward()

    # Both packages sent every attention through the no-max packed kernel:
    # self-attentions (no source) and cross-attentions (two sources).
    assert sorted(set(jcalls)) == sorted(set(tcalls)) == [0, 2]
    assert len(tcalls) == len(jcalls)

    def rel(a, w):
        a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
        return np.linalg.norm(a - w) / max(np.linalg.norm(w), 1e-30)

    assert rel(got.detach().numpy(), want) <= 1e-4
    bad = {n: rel(p.grad.numpy(), want_grads[n]) for n, p in net.named_parameters()
           if p.grad is not None and rel(p.grad.numpy(), want_grads[n]) > 1e-3}
    assert not bad, bad
