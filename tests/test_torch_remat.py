"""remat="save_dots" against the JAX package's, and the attention operators it
keeps (ROADMAP C3), on the CPU at a tiny size.

The attention entries that a block calls are `torch.library` operators
(kernels/flash.py): each passes `torch.library.opcheck`. Under "save_dots"
the port keeps by the JAX package's names what `vivid_tpu` keeps: the
attention outputs ("attn_out"), MPConv's products ("mpconv_out", less the
convolutions above VIVID_REMAT_HIRES_AREA) and, under VIVID_SAVE_WNORM, the
normalised weights ("wnorm"), and nothing else: no logits of the plain
attention. What JAX keeps comes from `saved_residuals`; what the port keeps
from its recompute policy's decisions in the forward pass. Each attention
operator runs once a block under "save_dots" and twice in a recomputed block
under True; the gradients of the three modes agree, and match JAX's; the
step's operation count is that of the plain versions run as aten operators.
"""

import collections
import dataclasses
import linecache
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as ckpt
from torch.utils._pytree import tree_leaves

from vivid_tpu.nn import mp as jmp
from vivid_tpu.nn import precond as jprecond
from vivid_tpu_torch.compat.from_jax import from_jax
from vivid_tpu_torch.core.summary import flops_analysis
from vivid_tpu_torch.diffusion.loss import NVLoss
from vivid_tpu_torch.kernels import flash
from vivid_tpu_torch.nn import unet
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig

from test_torch_model import _params

torch.set_num_threads(1)

# The 32 px net of tests/test_torch_repairs.py's C11 tests: three levels, so
# that the hires areas 256 and 64 each recompute another level's convolutions.
CFG = dict(img_resolution=32, model_channels=16, channel_mult=(1, 2, 2), num_blocks=1,
           attn_resolutions=(8,), channels_per_head=8, use_bf16=False)
NAMES = ("mpconv_out", "attn_out", "wnorm")
GRAD_REL_L2 = 1e-3   # tests/test_torch_train_step.py: fp32 sums in another order
MODES_REL_L2 = 1e-6  # the three modes of the port: the same operators


def _inputs():
    rng = np.random.RandomState(7)
    return (rng.randn(2, 2, 32, 32, 3).astype(np.float32),
            rng.randn(2, 32, 32, 3).astype(np.float32),
            np.array([0.5, 2.0], np.float32),
            rng.randn(2, 2, 20).astype(np.float32))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# -- the operators ---------------------------------------------------------------

OPCHECK_CASES = ("self", "self_zero_sink", "self_nomax", "xattn_biased", "xattn_nomax",
                 "stock_biased", "nomax", "nomax_biased")


def _opcheck_case(case):
    """(operator, its arguments) for `case`, seeded: packed rows at S 10, H 2,
    d 32 with two sources of 7 and 5 keys, or [B, H, S, D] at 16 queries and
    24 keys."""
    g = torch.Generator().manual_seed(OPCHECK_CASES.index(case))

    def t(*shape):
        return torch.randn(*shape, generator=g).requires_grad_()

    b, s, h, d = 2, 10, 2, 32
    if case.startswith("self"):
        sink = 2 * s if case == "self_zero_sink" else 0
        return flash._packed_self_op, (t(b, s, 3 * h * d), h, sink, case == "self_nomax", 1e-4)
    if case == "xattn_biased":
        return flash._packed_xattn_op, (t(b, s, 3 * h * d), [t(b, 7, 2 * h * d), t(b, 5, 2 * h * d)],
                                        h, [t(b, h, s, 7), t(b, h, s, 5)], False, 1e-4)
    if case == "xattn_nomax":
        return flash._packed_xattn_op, (t(b, s, 3 * h * d), [t(b, 7, 2 * h * d)], h, [], True, 1e-3)
    bias = t(1, h, 16, 24) if case.endswith("biased") else None
    op = flash._stock_op if case.startswith("stock") else flash._nomax_op
    return op, (t(1, h, 16, d), t(1, h, 24, d), t(1, h, 24, d), bias)


@pytest.mark.parametrize("case", OPCHECK_CASES)
def test_attention_operator_passes_opcheck(case):
    """Schema, autograd registration, fake tensors and an AOT trace with its
    backward, each on the CPU's plain version; a biased and a zero-sink case
    among them."""
    op, args = _opcheck_case(case)
    results = torch.library.opcheck(op, args)
    assert set(results.values()) == {"SUCCESS"}, results


def test_operator_gradients_equal_the_plain_versions():
    """Through the operators, the packed gradients are K3's and K4's plain
    versions' and the big-S ones K8's, exactly."""
    qkv, feats, h, biases, _, eps = _opcheck_case("xattn_biased")[1]
    out = flash.packed_xattn(qkv, feats, h, biases=biases, eps=eps)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(out, [qkv, *feats, *biases], g)
    dqkv, dfeats, dbiases = flash.flash_fused_packed_xattn_bwd_ref(
        qkv.detach(), [f.detach() for f in feats], g, h, [b.detach() for b in biases], eps)
    for a, w in zip(got, (dqkv, *dfeats, *dbiases)):
        assert torch.equal(a, w)
    q, k, v, bias = _opcheck_case("nomax_biased")[1]
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(flash.nomax_attention(q, k, v, bias), [q, k, v, bias], g)
    out, lse = flash.flash_attention_ref(q.detach(), k.detach(), v.detach(), bias.detach())
    want = flash.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), bias.detach(),
                                         out, lse, g)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# -- what save_dots keeps, against saved_residuals -------------------------------

def _jax_named_residuals(remat):
    """{(name, elements, itemsize): count} of `vivid_tpu`'s residuals that a
    `checkpoint_name` call puts out, for one forward of the 32 px net; the
    name is the one on the call's line (the convolution's, which names it by
    area, is "mpconv_out": an "mpconv_out_hires" inside a remat is no
    residual)."""
    cfg = jprecond.PrecondConfig(**CFG, remat=remat)
    params = jprecond.precond_init(jax.random.PRNGKey(0), cfg)
    args = tuple(jnp.asarray(a) for a in _inputs())
    from jax._src.ad_checkpoint import saved_residuals
    out = collections.Counter()
    for aval, why in saved_residuals(lambda p: jprecond.precond_apply(p, cfg, *args).sum(),
                                     params):
        m = re.search(r"from (\S+\.py):(\d+):\d+ \((\w+)\)", why)
        line = linecache.getline(m[1], int(m[2])) if m else ""
        if "checkpoint_name(" in line:
            name = next((n for n in NAMES if f'"{n}"' in line),
                        "attn_out" if m[3] == "block_apply" else "mpconv_out")
            out[(name, int(aval.size), aval.dtype.itemsize)] += 1
    return out


@pytest.fixture(scope="module")
def jax_full_remat():
    """The named residuals under remat=True: those of the blocks no remat
    wraps (the base net's encoder half), which plain autodiff saves."""
    return _jax_named_residuals(True)


def _port_kept(monkeypatch):
    """{(name, elements, itemsize): count} of what the port's save_dots policy
    keeps in one forward of the 32 px net, named by operator: an attention
    operator's output "attn_out", a product's "mpconv_out", any other
    "wnorm"."""
    aten = torch.ops.aten
    products = (aten.mm.default, aten.addmm.default, aten.bmm.default,
                aten.convolution.default)
    kept = collections.Counter()
    policy_of = unet._save_dots_policy

    def recording(hires_area):
        policy = policy_of(hires_area)

        def record(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if decision == ckpt.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                name = ("attn_out" if op.namespace == "vivid"
                        else "mpconv_out" if op in products else "wnorm")
                for t in tree_leaves(ctx.op_output):
                    kept[(name, t.numel(), t.element_size())] += 1
            return decision
        return record

    monkeypatch.setattr(unet, "_save_dots_policy", recording)
    net = NVPrecond(PrecondConfig(**CFG, remat="save_dots"), seed=3).train()
    out = net(*(torch.from_numpy(a) for a in _inputs()))
    out.square().sum().backward()
    return kept


def _bytes(counter):
    total = collections.Counter()
    for (name, n, size), count in counter.items():
        total[name] += n * size * count
    return dict(total)


@pytest.mark.parametrize("area,wnorm", [(None, False), (256, False), (64, False), (None, True)])
def test_save_dots_keeps_what_jax_keeps_by_name(area, wnorm, jax_full_remat, monkeypatch):
    """What the JAX package's save_dots adds to the full remat's residuals
    (its policy's residuals) is what the port's policy keeps, tensor for
    tensor by element count and dtype, at the default hires area, at 256 and
    64, and with VIVID_SAVE_WNORM: the attention outputs among it, and no
    plain-attention logits."""
    if area is None:
        monkeypatch.delenv("VIVID_REMAT_HIRES_AREA", raising=False)
    else:
        monkeypatch.setenv("VIVID_REMAT_HIRES_AREA", str(area))
        monkeypatch.setattr(jmp, "REMAT_HIRES_AREA", area)   # read at import in vivid_tpu
    if wnorm:
        monkeypatch.setenv("VIVID_SAVE_WNORM", "1")
    else:
        monkeypatch.delenv("VIVID_SAVE_WNORM", raising=False)
    want = _jax_named_residuals("save_dots") - jax_full_remat
    got = _port_kept(monkeypatch)
    assert got == want, (_bytes(got), _bytes(want))
    names = {name for name, _, _ in got}
    assert names == ({"mpconv_out", "attn_out", "wnorm"} if wnorm else {"mpconv_out", "attn_out"})


# -- launches, gradients and the operation count ----------------------------------

def _expected_runs(cfg, remat):
    """Runs of each attention operator's forward and backward in one loss and
    its backward: once a block, twice where remat=True recomputes the block
    (the decoder's blocks and every block of the encoder)."""
    want = collections.Counter()
    for ucfg, fwd in ((cfg.unet_cfg, "flash_fused_packed_xattn"),
                      (cfg.encoder_cfg, "flash_fused_packed")):
        for name, _, _ in unet.attention_feature_spec(ucfg):
            recomputed = remat is True and (name.startswith("dec/") or ucfg.kind == "encoder")
            want[fwd] += 2 if recomputed else 1
            want[fwd + "_bwd"] += 1
    return want


def _grads(net, monkeypatch=None):
    """One forward and backward of sum(D_x^2) -> {name: gradient}, and the
    runs of each packed attention wrapper (the operators' implementations)."""
    runs = collections.Counter()
    if monkeypatch is not None:
        for name in ("flash_fused_packed", "flash_fused_packed_xattn", "flash_fused_packed_bwd",
                     "flash_fused_packed_xattn_bwd"):
            real = getattr(flash, name)
            monkeypatch.setattr(flash, name, lambda *a, name=name, real=real: (
                runs.update([name]), real(*a))[1])
    for p in net.parameters():
        p.grad = None
    net(*(torch.from_numpy(a) for a in _inputs())).square().sum().backward()
    # A parameter the loss does not reach has no gradient: zero, as jax.grad gives it.
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
            for n, p in net.named_parameters()}, runs


@pytest.fixture(scope="module")
def jax_grads():
    jcfg = jprecond.PrecondConfig(**CFG, remat="save_dots")
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 11)
    args = tuple(jnp.asarray(a) for a in _inputs())
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jprecond.precond_apply(p, jcfg, *args) ** 2)))(
        params)
    return jcfg, params, {k: v.numpy() for k, v in from_jax(jax.tree.map(np.asarray, grads)).items()}


@pytest.mark.parametrize("remat", [False, True, "save_dots"])
def test_remat_launches_and_gradients(remat, jax_grads, monkeypatch):
    """Each mode runs each attention operator as often as its plan says
    (save_dots once a block, as without remat), gives the gradients of
    remat=False to 1e-6 and `vivid_tpu`'s under save_dots to 1e-3 a
    parameter."""
    jcfg, params, want = jax_grads
    state = from_jax(params)

    def net(mode):
        n = NVPrecond(PrecondConfig(**dict(dataclasses.asdict(jcfg), remat=mode)))
        n.load_state_dict(state, strict=True)
        return n.train()

    plain, _ = _grads(net(False))
    model = net(remat)
    got, runs = _grads(model, monkeypatch)
    assert runs == _expected_runs(model.cfg, remat)
    flat = lambda g: np.concatenate([g[n].ravel() for n in sorted(g)])
    assert _rel_l2(flat(got), flat(plain)) <= MODES_REL_L2
    bad = {n: _rel_l2(g, want[n]) for n, g in got.items()
           if np.linalg.norm(want[n]) > 0 and _rel_l2(g, want[n]) > GRAD_REL_L2}
    assert not bad, bad
    assert all(np.linalg.norm(g) == 0 for n, g in got.items() if np.linalg.norm(want[n]) == 0)


# The count of one tiny training step (NVLoss, batch 2, 32 px, seed 3) with the
# attention's plain versions run as aten operators, for each mode.
STEP_FLOPS = {False: 1511453696, True: 1944093696, "save_dots": 1511453696}


@pytest.mark.parametrize("tallied", [False, True], ids=["plain", "tallied"])
@pytest.mark.parametrize("remat", [False, True, "save_dots"])
def test_flops_of_a_tiny_step_count_each_attention_once(remat, tallied, monkeypatch):
    """The operators count their forward once: by their formula where the
    plain version ran, by the kernel's tally where one ran (here the plain
    versions tallying as the kernels do), never both."""
    if tallied:
        for name, ops in (("flash_fused_packed", lambda qkv, h, *a: (qkv, (), h)),
                          ("flash_fused_packed_xattn", lambda qkv, feats, h, *a: (qkv, feats, h))):
            ref = getattr(flash, name + "_ref")
            monkeypatch.setattr(flash, name, lambda *a, name=name, ref=ref, ops=ops: (
                flash.launched(name, flash._packed_ops(*ops(*a), 2)), ref(*a))[1])
    net = NVPrecond(PrecondConfig(**CFG, remat=remat), seed=3).train()
    gen = torch.Generator().manual_seed(4)
    src, tgt = torch.randn(2, 2, 32, 32, 3, generator=gen), torch.randn(2, 32, 32, 3, generator=gen)
    geo = torch.randn(2, 2, 20, generator=gen)
    r = flops_analysis(lambda: NVLoss()(net, src, tgt, geo, generator=torch.Generator()
                                        .manual_seed(0)).sum().backward())
    assert r["flops"] == STEP_FLOPS[remat]
    assert bool(r["kernels"]) == tallied
    assert r["operators"] + sum(r["kernels"].values()) == r["flops"]
