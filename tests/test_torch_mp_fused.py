"""The fused elementwise chains of the EDM2 block (kernels/mp_fused.py) on
the CPU: their plain versions are the composites the blocks ran before them,
bit for bit; the entries take the kernels only where `fused` holds; a block
and a whole net give the same bits through the kernels' entries (their
wrappers swapped for the plain versions) as through the composites; under
autograd the block still runs the composites; what the CUDA wrappers refuse
before any launch."""

import collections
import math

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from vivid_tpu_torch.kernels import attention, build, flash, mp_fused
from vivid_tpu_torch.nn import blocks
from vivid_tpu_torch.nn.blocks import ATTN_BALANCE, CLIP_ACT, RES_BALANCE, Block, BlockConfig
from vivid_tpu_torch.nn.mp import resample
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.nn.unet import build_plan

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]


def _rand(*shape, seed=0, scale=1.0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(*shape, generator=gen)).to(dtype)


# The composites as the blocks and the U-Net wrote them before the fused
# entries, operator by operator.

def _silu(x):
    return F.silu(x) / 0.596


def _composite(op, *args):
    if op == "norm_silu":
        (x,) = args
        norm = torch.sqrt(x.float().square().sum(dim=-1, keepdim=True))
        xn = x / (1e-4 + math.sqrt(1 / x.shape[-1]) * norm).to(x.dtype)
        return xn, _silu(xn)
    if op == "scale_silu":
        y, c = args
        return _silu(y * c[:, None, None, :].to(y.dtype))
    if op == "sum_clip":
        a, b, t, clip = args
        x = (a + t * (b - a)) / math.sqrt((1 - t) ** 2 + t ** 2)
        return x if clip is None else x.clamp(-clip, clip)
    a, b, t = args
    na, nb = a.shape[-1], b.shape[-1]
    c = math.sqrt((na + nb) / ((1 - t) ** 2 + t ** 2))
    x = torch.cat([c / math.sqrt(na) * (1 - t) * a, c / math.sqrt(nb) * t * b], dim=-1)
    return x, _silu(x)


def _args(op, channels, dtype):
    """Inputs of `op` at [2, 3, 5, channels]; the sums at 300x scale, so that
    the clip bites."""
    x = _rand(2, 3, 5, channels, dtype=dtype)
    if op == "norm_silu":
        return (x,)
    if op == "scale_silu":
        return x, 1 + _rand(2, channels, seed=1)
    if op == "sum_clip":
        a, b = (_rand(2, 3, 5, channels, seed=s, scale=300.0, dtype=dtype) for s in (2, 3))
        return a, b, 0.3, 256.0
    return x, _rand(2, 3, 5, channels // 2, seed=4, dtype=dtype), 0.5


# op: (entry, plain version, CUDA wrapper's name, the wrapper's extra arguments)
ENTRIES = {"norm_silu": (mp_fused.norm_silu, mp_fused.norm_silu_ref, "_norm_silu_cuda",
                         (mp_fused.NORM_EPS,)),
           "scale_silu": (mp_fused.scale_silu, mp_fused.scale_silu_ref, "_scale_silu_cuda", ()),
           "sum_clip": (mp_fused.mp_sum_clip, mp_fused.mp_sum_clip_ref, "_sum_clip_cuda", ()),
           "cat_silu": (mp_fused.cat_silu, mp_fused.cat_silu_ref, "_cat_silu_cuda", ())}


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("channels", [16, 64])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("op", sorted(ENTRIES))
def test_plain_versions_are_the_composites(op, dtype, channels):
    """On the CPU the plain version and the entry give the composite's bits
    (the concatenation's entry gives no mp_silu there: the block computes
    it); the sum's clip bites on these inputs, and without a clip it does
    not."""
    args = _args(op, channels, dtype)
    want = _composite(op, *args)
    entry, plain = ENTRIES[op][:2]
    before = dict(flash.launches)
    with torch.no_grad():
        assert _same(plain(*args), want)
        got = entry(*args)
        assert _same(got, want) if op != "cat_silu" else (_same(got[0], want[0])
                                                          and got[1] is None)
    assert flash.launches == before   # CPU tensors launch nothing
    if op == "sum_clip":
        assert want.abs().max() == CLIP_ACT
        unclipped = _composite(op, *args[:3], None)
        assert unclipped.abs().max() > CLIP_ACT
        assert _same(entry(*args[:3]), unclipped)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("widths", [(16, 32), (32, 16), (64, 32), (24, 40)])
def test_cat_plain_version_at_unequal_widths(widths, dtype):
    """The decoder's concatenations join parts of unequal widths where a
    level changes: each part keeps its own scale, bit for bit the
    composite's."""
    ca, cb = widths
    a = _rand(2, 3, 5, ca, seed=10, dtype=dtype)
    b = _rand(2, 3, 5, cb, seed=11, dtype=dtype)
    want = _composite("cat_silu", a, b, 0.5)
    assert want[0].shape[-1] == ca + cb
    assert _same(mp_fused.cat_silu_ref(a, b, 0.5), want)


@pytest.mark.parametrize("op", sorted(ENTRIES))
def test_entries_take_the_kernel_only_where_fused(op, monkeypatch):
    """Where `fused` holds the entry returns its CUDA wrapper's outputs,
    given the entry's arguments; where it does not, the plain version's,
    and the wrapper is never reached."""
    entry, plain, wrapper, extra = ENTRIES[op]
    args = _args(op, 16, torch.float32)
    seen = []
    monkeypatch.setattr(mp_fused, wrapper, lambda *a: seen.append(a) or "kernel")
    monkeypatch.setattr(mp_fused, "fused", lambda x: True)
    assert entry(*args) == "kernel" and len(seen) == 1
    assert all(g is w if isinstance(w, torch.Tensor) else g == w
               for g, w in zip(seen[0], args + extra, strict=True))
    monkeypatch.setattr(mp_fused, "fused", lambda x: False)
    got = entry(*args)
    assert len(seen) == 1
    want = plain(*args)
    assert _same(got, want) if op != "cat_silu" else _same(got[0], want[0])


def _refusing_library():
    raise AssertionError("the wrapper reached the kernel library")


@pytest.mark.parametrize("case", ["half", "channels", "sum_shapes", "cat_rows", "c_shape", "clip"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case, monkeypatch):
    """The CUDA wrappers check type, channels and shapes before they reach
    the library: fp16, channels that fill no whole 16-byte vector, operands
    that differ, a scale of the wrong shape, a clip of 0."""
    monkeypatch.setattr(build, "library", _refusing_library)
    x = _rand(2, 3, 5, 16, dtype=torch.bfloat16)
    calls = {
        "half": lambda: mp_fused._norm_silu_cuda(x.half(), 1e-4),
        "channels": lambda: mp_fused._cat_silu_cuda(x, x[..., :12], 0.5),
        "sum_shapes": lambda: mp_fused._sum_clip_cuda(x, x[:1], 0.3, None),
        "cat_rows": lambda: mp_fused._cat_silu_cuda(x, x[:, :2], 0.5),
        "c_shape": lambda: mp_fused._scale_silu_cuda(x, torch.ones(2, 8)),
        "clip": lambda: mp_fused._sum_clip_cuda(x, x, 0.3, 0.0),
    }
    with pytest.raises(ValueError):
        calls[case]()


def test_fused_only_on_a_card_without_autograd():
    x = torch.ones(1, 1, 1, 8)
    with torch.no_grad():
        assert not mp_fused.fused(x)
    with FakeTensorMode():
        card = torch.empty(1, 1, 1, 8, device="cuda")
        assert not mp_fused.fused(card)
        with torch.no_grad():
            assert mp_fused.fused(card)
        with torch.inference_mode():
            assert mp_fused.fused(card)


@pytest.fixture
def on_kernels(monkeypatch):
    """The entries take the kernels' path wherever autograd is off, CPU
    tensors included, with each CUDA wrapper swapped for its plain version;
    counts each kernel's calls."""
    calls = collections.Counter()
    monkeypatch.setattr(mp_fused, "fused", lambda x: not torch.is_grad_enabled())
    for name, (_, plain, wrapper, _) in ENTRIES.items():
        monkeypatch.setattr(mp_fused, wrapper, lambda *a, plain=plain, name=name: (
            calls.update(["mp_" + name]), plain(*a))[1])
    return calls


BLOCKS = {
    "enc_attention": dict(flavor="enc", attention=True),
    "enc_skip_conv": dict(flavor="enc", in_channels=16),
    "enc_down": dict(flavor="enc", resample_mode="down"),
    "dec_skip_conv_attention": dict(flavor="dec", in_channels=48, attention=True),
    "dec_up": dict(flavor="dec", resample_mode="up"),
    "dec_xattn": dict(flavor="dec", attention=True, xattn=True),
}


def _block(kind, dtype):
    kw = dict(BLOCKS[kind])
    cin = kw.pop("in_channels", 32)
    block = Block(BlockConfig(in_channels=cin, out_channels=32, emb_channels=20,
                              channels_per_head=8, **kw))
    with torch.no_grad():
        block.reset_parameters(torch.Generator().manual_seed(5))
        block.emb_gain.fill_(1.0)
    x = _rand(2, 8, 8, cin, seed=6, scale=3.0, dtype=dtype)
    emb = _rand(2, 20, seed=7)
    feats = [_rand(2, 8, 8, 32, seed=8 + i, dtype=dtype) for i in range(2)] \
        if kw.get("xattn") else None
    return block.to(dtype).eval(), x, emb, feats


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_without_autograd_through_the_kernels_equals_with(kind, dtype, on_kernels):
    """A block's forward with autograd off, through the kernels' entries (the
    decoder's given its mp_silu as `cat_silu` gives it), equals its forward
    with autograd on, through the composites, bit for bit."""
    block, x, emb, feats = _block(kind, dtype)
    want = block(x.clone().requires_grad_(), emb, feats)
    assert want.requires_grad and not on_kernels
    with torch.no_grad():
        got = block(x, emb, feats)
        dec_cat = kind == "dec_skip_conv_attention"
        given = block(x, emb, feats, x_silu=F.silu(x) / 0.596) if dec_cat else got
    assert _same(got, want.detach()) and _same(given, got)
    enc = BLOCKS[kind]["flavor"] == "enc"
    assert on_kernels == collections.Counter(
        mp_scale_silu=1 + dec_cat, mp_sum_clip=(1 + ("attention" in BLOCKS[kind])) * (1 + dec_cat),
        **({"mp_norm_silu": 1} if enc else {}))


def _today(block, x, emb):
    """A self-attention or plain block's forward as it was written before the
    fused entries, with its composites inline."""
    cfg = block.cfg
    x = resample(x, cfg.resample_mode)
    if cfg.flavor == "enc":
        if block.conv_skip is not None:
            x = block.conv_skip(x)
        x = _composite("norm_silu", x)[0]
    y = block.conv_res0(_silu(x))
    c = block.emb_linear(emb, gain=block.emb_gain) + 1.0
    y = block.conv_res1(_silu(y * c[:, None, None, :].to(y.dtype)))
    if cfg.flavor == "dec" and block.conv_skip is not None:
        x = block.conv_skip(x)
    x = _composite("sum_clip", x, y, RES_BALANCE, None)
    if cfg.num_heads:
        b, h, w, ch = x.shape
        qkv = blocks._packed_linear(block.attn_qkv, x.reshape(b, h * w, ch), cfg.num_heads, 3)
        y = attention.self_attention_from_packed(qkv, cfg.num_heads)
        y = F.linear(y, block.attn_proj.normalized_weight(y.dtype).flatten(1))
        x = _composite("sum_clip", x, y.reshape(b, h, w, ch), ATTN_BALANCE, None)
    return x.clamp(-CLIP_ACT, CLIP_ACT)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["enc_attention", "enc_skip_conv", "dec_skip_conv_attention",
                                  "dec_up"])
def test_training_forward_and_backward_are_the_composites(kind, dtype):
    """With autograd on, a block's output and every gradient (its parameters'
    and its input's) are those of its forward as written before the fused
    entries, bit for bit."""
    block, x, emb, _ = _block(kind, dtype)
    with torch.no_grad():
        g = _rand(*block(x, emb).shape, seed=9, dtype=dtype)

    def grads(fn):
        for p in block.parameters():
            p.grad = None
        leaf = x.clone().requires_grad_()
        out = fn(leaf)
        out.backward(g)
        return [out.detach(), leaf.grad] + [p.grad for p in block.parameters()]

    got = grads(lambda leaf: block(leaf, emb))
    want = grads(lambda leaf: _today(block, leaf, emb))
    assert all(_same(a, b) for a, b in zip(got, want))


def _net_launches(cfg):
    """Kernel calls of one autograd-off forward of the U-Net `cfg`."""
    calls = collections.Counter()
    enc, dec = build_plan(cfg)
    for e in enc + dec:
        if e.block is None:
            continue
        calls["mp_norm_silu"] += e.block.flavor == "enc"
        calls["mp_cat_silu"] += "_block" in e.name and e.name.startswith("dec/")
        calls["mp_scale_silu"] += 1
        calls["mp_sum_clip"] += 1 + (e.block.num_heads > 0)
    return calls


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["guided_base", "uncond", "super_res"])
def test_net_without_autograd_through_the_kernels_equals_with(kind, dtype, on_kernels):
    """A whole NVPrecond (encoder and denoiser) gives the same D_x with
    autograd off, through the kernels' entries, as with autograd on, through
    the composites; the kernels run as the plan says: a norm an encoder block,
    a concatenation a decoder block after a skip, a scale a block, a sum a
    block and an attention."""
    sr = kind == "super_res"
    cfg = PrecondConfig(img_resolution=16, model_channels=16, channel_mult=(1, 2),
                        num_blocks=1, attn_resolutions=(8,), channels_per_head=8,
                        extra_attn=1, use_bf16=dtype == torch.bfloat16, remat=False,
                        uncond=kind == "uncond", super_res=sr, num_sources=1 if sr else 2,
                        target_label_dim=20 if sr else 40)
    net = NVPrecond(cfg, seed=3)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("out_gain", "emb_gain")):
                p.fill_(1.0)
    net.eval()
    n = cfg.num_sources
    src, dst = _rand(2, n, 16, 16, 3, seed=1).clamp(-1, 1), _rand(2, 16, 16, 3, seed=2)
    sigma, geo = torch.tensor([0.5, 2.0]), _rand(2, n, 20, seed=3)
    extra = dict(conditioning_image=_rand(2, 16, 16, 3, seed=4).clamp(-1, 1),
                 cond_noise=_rand(2, 16, 16, 3, seed=5)) if sr else {}
    want = net(src, dst, sigma.requires_grad_(), geo, **extra)
    assert want.requires_grad and not on_kernels
    with torch.no_grad():
        got = net(src, dst, sigma.detach(), geo, **extra)
    assert torch.equal(got, want.detach())
    calls = _net_launches(cfg.unet_cfg)
    if not cfg.uncond:
        calls.update(_net_launches(cfg.encoder_cfg))
    assert on_kernels == calls and calls["mp_cat_silu"] > 0
