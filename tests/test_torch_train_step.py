"""The port's training step against the JAX package's `make_train_step` on
the same initial state, batches, sigma and noise (CPU, fp32, tiny widths):
per-parameter gradients, three whole steps, gradient accumulation, the NaN
scrub, forced weight normalisation and the recompute modes.

The JAX package keeps the Fourier features `freqs`/`phases` in its parameter
tree and differentiates them, so its step moves them (a defect, shown by
`test_jax_step_moves_the_fourier_features`); the port keeps them fixed as
buffers. Every other comparison here wraps the JAX loss so that those leaves
are `stop_gradient`ed, which compares the two steps around the defect.

Tolerances. Both sides run fp32 and sum in different orders, so a gradient
leaf agrees to a relative L2 of 1e-3. Adam's first steps move every element
by about lr * sign(g), whatever |g|: an element whose gradient is at rounding
level may take the other sign and land up to 2 lr away per step. So stepped
tensors are held in units of lr: the share of elements further than 0.01 lr
per step from JAX's must stay below 1e-3 in every leaf, none may be further
than 2.1 lr per step, and the relative L2 of the whole update stays below
2e-2. No leaf had to be excluded at these sizes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.diffusion import loss as jloss
from vivid_tpu.diffusion.phema import std_to_exp
from vivid_tpu.nn import precond as jprecond
from vivid_tpu.train import step as jstep
from vivid_tpu_torch.compat.from_jax import (from_jax, train_state_from_jax,
                                             train_state_to_jax)
from vivid_tpu_torch.diffusion import loss
from vivid_tpu_torch.nn.mp import MPConv
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train import step

from test_torch_loss import jax_draws
from test_torch_model import TINY, _params

torch.set_num_threads(1)

LR = 0.01
STEPS = 3
GRAD_REL_L2 = 1e-3
# One level, one block: the smallest net with every kind of block, for the
# checks that need a JAX compile of their own.
MICRO = dict(TINY, channel_mult=(1,), attn_resolutions=(8,))


def _stop_fourier(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jax.lax.stop_gradient(x)
        if path[-1].key in ("freqs", "phases") else x, params)


def _wrapped(jfn):
    def loss_fn(params, cfg, rng, src, tgt, geometry, train=True):
        return jfn(_stop_fourier(params), cfg, rng, src, tgt, geometry, train=train)
    return loss_fn


def _batches(n, b, res, seed):
    rng = np.random.RandomState(seed)
    return [dict(src=rng.randn(b, 2, res, res, 3).astype(np.float32),
                 tgt=rng.randn(b, res, res, 3).astype(np.float32),
                 geometry=rng.randn(b, 2, 20).astype(np.float32)) for _ in range(n)]


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _numpy_state(state):
    return jax.tree.map(np.asarray, state._asdict())


def _setup(uncond, res=16, tiny=TINY, **train_kw):
    jcfg = jprecond.PrecondConfig(img_resolution=res, uncond=uncond, extra_attn=1, **tiny)
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 6)
    jcfgt = jstep.TrainConfig(batch_size=2, ref_lr=LR, rampup_Mimg=0.0, nimg_mult=6, **train_kw)
    tcfgt = step.TrainConfig(batch_size=2, ref_lr=LR, rampup_Mimg=0.0, nimg_mult=6, **train_kw)
    jfn = jloss.NVLoss(P_mean=-0.8, P_std=1.6)
    tfn = loss.NVLoss(P_mean=-0.8, P_std=1.6)
    exps = tuple(float(std_to_exp(s) + 1) for s in jcfgt.ema_stds)
    state = jstep.init_train_state(jax.tree.map(jnp.asarray, params), jcfgt)
    return EasyNS(jcfg=jcfg, tcfg=PrecondConfig(**dataclasses.asdict(jcfg)), jfn=jfn, tfn=tfn,
                  jcfgt=jcfgt, tcfgt=tcfgt, exps=exps, state=state)


class EasyNS(dict):
    __getattr__ = dict.__getitem__


def _draws(jfn, key, shape, num_accum=1):
    """sigma and eps for a whole batch as the JAX step draws them: one key
    per microbatch."""
    keys = [key] if num_accum == 1 else list(jax.random.split(key, num_accum))
    micro = (shape[0] // num_accum,) + tuple(shape[1:])
    parts = [jax_draws(jfn, k, micro) for k in keys]
    return (torch.from_numpy(np.concatenate([p[0] for p in parts])),
            torch.from_numpy(np.concatenate([p[1] for p in parts])))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _hold_stepped(got, want, before, steps, what):
    """`got` (port) against `want` (JAX), both moved from `before` by `steps`
    Adam steps; see the module docstring."""
    bad = {}
    for name in want:
        d = np.abs(got[name].astype(np.float64) - want[name])
        assert d.max() <= 2.1 * LR * steps, f"{what} {name}: off by {d.max() / LR:.2f} lr"
        share = float((d > 0.01 * LR * steps).mean())
        if share > 1e-3:
            bad[name] = share
    assert not bad, f"{what}: share of elements beyond 0.01 lr per step: {bad}"
    names = list(want)
    upd_got = np.concatenate([(got[n] - before[n]).ravel() for n in names])
    upd_want = np.concatenate([(want[n] - before[n]).ravel() for n in names])
    assert _rel_l2(upd_got, upd_want) <= 2e-2, f"{what}: update rel L2 {_rel_l2(upd_got, upd_want)}"


def _flat(tree):
    return {k: v.numpy() for k, v in from_jax(tree).items()}


@pytest.fixture(scope="module", params=[False, True], ids=["vivid-base", "vivid-uncond"])
def run(request):
    """Three steps of both packages from the same state, and the first
    step's per-parameter gradients of the scalar microbatch loss."""
    env = _setup(uncond=request.param)
    jloss_fn = _wrapped(env.jfn)
    jstep_fn = jstep.make_train_step(jloss_fn, env.jcfg, env.jcfgt, env.exps)

    def scalar(params, rng, batch):
        l = jloss.clamp_loss(jloss_fn(params, env.jcfg, rng, batch["src"], batch["tgt"],
                                      batch["geometry"], train=True))
        return jnp.sum(l) * (env.jcfgt.loss_scaling / batch["tgt"].shape[0])

    both = jax.jit(lambda s, b, k: (jax.grad(scalar)(s.params, k, b), jstep_fn(s, b, k)))
    batches = _batches(STEPS, 2, 16, seed=7)
    keys = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]
    start = _numpy_state(env.state)
    jstate, jstats, jgrads = env.state, [], None
    for b, k in zip(batches, keys):
        g, (jstate, st) = both(jstate, b, k)
        jgrads = jgrads if jgrads is not None else jax.tree.map(np.asarray, g)
        jstats.append({n: float(v) for n, v in st.items()})

    tstate = train_state_from_jax(start, env.tcfg)
    tstep = step.make_train_step(env.tfn, env.tcfgt)
    # The first step's gradients, read before the step clears them.
    sigma, eps = _draws(env.jfn, keys[0], batches[0]["tgt"].shape)
    tb = _tbatch(batches[0])
    l = loss.clamp_loss(env.tfn(tstate.net, tb["src"], tb["tgt"], tb["geometry"],
                                sigma=sigma, eps=eps))
    (l.sum() / 2).backward()
    # A parameter the loss does not reach (x_attn_kv of the unconditional
    # model) has no gradient: zero, as jax.grad gives it.
    tgrads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
              for n, p in zip(tstate.names, tstate.params)}
    tstats = []
    for b, k in zip(batches, keys):
        sigma, eps = _draws(env.jfn, k, b["tgt"].shape)
        st = tstep(tstate, _tbatch(b), sigma=sigma, eps=eps)
        tstats.append({n: float(v) for n, v in st.items()})
    return EasyNS(env=env, start=start, jstate=_numpy_state(jstate), tstate=tstate,
                  jstats=jstats, tstats=tstats, jgrads=jgrads, tgrads=tgrads)


def test_gradients_match_jax_grad(run):
    want = _flat(run.jgrads)
    assert set(run.tgrads) == set(want) - {k for k in want if k.endswith(("freqs", "phases"))}
    worst = {n: _rel_l2(g, want[n]) for n, g in run.tgrads.items()
             if np.linalg.norm(want[n]) > 0}
    bad = {n: e for n, e in worst.items() if e > GRAD_REL_L2}
    assert not bad, bad
    for n, g in run.tgrads.items():   # a leaf JAX gives no gradient gets none here
        if np.linalg.norm(want[n]) == 0:
            assert np.linalg.norm(g) == 0, n


def test_three_steps_match_make_train_step(run):
    got = train_state_to_jax(run.tstate)
    assert int(got["cur_nimg"]) == int(run.jstate["cur_nimg"]) == STEPS * 2 * 6
    assert int(got["adam_step"]) == int(run.jstate["adam_step"]) == STEPS
    for js, ts in zip(run.jstats, run.tstats):
        assert set(js) == set(ts)
        for k in js:   # fp32 sums over the batch in another order
            assert ts[k] == pytest.approx(js[k], rel=1e-4), k
    before = _flat(run.start["params"])
    _hold_stepped(_flat(got["params"]), _flat(run.jstate["params"]), before, STEPS, "params")
    for i in range(2):
        _hold_stepped(_flat(got["emas"][i]), _flat(run.jstate["emas"][i]), before, STEPS,
                      f"ema {i}")
    # Moments are running means of the clipped gradients.
    for key, tol in (("adam_m", 1e-3), ("adam_v", 2e-3)):
        want, have = _flat(run.jstate[key]), _flat(got[key])
        bad = {n: _rel_l2(have[n], w) for n, w in want.items()
               if np.linalg.norm(w) > 0 and _rel_l2(have[n], w) > tol}
        assert not bad, (key, bad)


def test_port_keeps_the_fourier_features_fixed(run):
    got = _flat(train_state_to_jax(run.tstate)["params"])
    before = _flat(run.start["params"])
    names = [n for n in before if n.endswith(("freqs", "phases"))]
    assert len(names) == (4 if run.env.jcfg.uncond else 6)
    for n in names:
        np.testing.assert_array_equal(got[n], before[n])
    # The unconditional model feeds emb_label zeros and never calls x_attn_kv.
    still = names + [n for n in before if run.env.jcfg.uncond
                     and ("emb_label" in n or "x_attn_kv" in n)]
    for n in before:
        assert np.array_equal(got[n], before[n]) == (n in still), n


def test_epipolar_gradients_match_jax_grad():
    """With the epipolar bias on, the learned epipolar_mixing gets its
    gradient through the bias input of the cross-attention."""
    jcfg = jprecond.PrecondConfig(img_resolution=8, epipolar_attention_bias=True, **MICRO)
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 9)
    batch = _batches(1, 2, 8, seed=9)[0]
    batch["geometry"] *= 0.3
    jfn, key = _wrapped(jloss.NVLoss()), jax.random.PRNGKey(4)
    want = _flat(jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: jnp.sum(jfn(p, jcfg, key, batch["src"], batch["tgt"], batch["geometry"]))
    ))(params)))
    net = NVPrecond(PrecondConfig(**dataclasses.asdict(jcfg)))
    net.load_state_dict(from_jax(params), strict=True)
    sigma, eps = _draws(jloss.NVLoss(), key, batch["tgt"].shape)
    tb = _tbatch(batch)
    loss.NVLoss()(net.train(), tb["src"], tb["tgt"], tb["geometry"], sigma=sigma,
                  eps=eps).sum().backward()
    mixing = [n for n, _ in net.named_parameters() if n.endswith("epipolar_mixing")]
    assert len(mixing) == 4
    for n, p in net.named_parameters():
        assert _rel_l2(p.grad.numpy(), want[n]) <= GRAD_REL_L2, n
    assert all(np.linalg.norm(want[n]) > 0 for n in mixing)


def test_jax_step_moves_the_fourier_features():
    """The defect the port does not copy: the unwrapped JAX step gives
    emb_fourier.freqs a gradient and Adam moves it."""
    env = _setup(uncond=False, res=8, tiny=MICRO)
    jstep_fn = jax.jit(jstep.make_train_step(env.jfn, env.jcfg, env.jcfgt, env.exps))
    batch = _batches(1, 2, 8, seed=1)[0]
    after, _ = jstep_fn(env.state, batch, jax.random.PRNGKey(0))
    before = np.asarray(env.state.params["unet"]["emb_fourier"]["freqs"])
    moved = np.abs(np.asarray(after.params["unet"]["emb_fourier"]["freqs"]) - before)
    assert moved.max() > 0.5 * LR


def test_accumulation_matches_jax():
    """num_accum = 2: two microbatches of 2 rows, gradients averaged."""
    env = _setup(uncond=False, res=8, tiny=MICRO, num_accum=2)
    env.jcfgt = dataclasses.replace(env.jcfgt, batch_size=4)
    env.tcfgt = dataclasses.replace(env.tcfgt, batch_size=4)
    jstep_fn = jax.jit(jstep.make_train_step(_wrapped(env.jfn), env.jcfg, env.jcfgt, env.exps))
    batch = _batches(1, 4, 8, seed=2)[0]
    key = jax.random.PRNGKey(5)
    start = _numpy_state(env.state)
    jafter, jstats = jstep_fn(env.state, {k: v.reshape((2, 2) + v.shape[1:])
                                          for k, v in batch.items()}, key)
    tstate = train_state_from_jax(start, env.tcfg)
    sigma, eps = _draws(env.jfn, key, batch["tgt"].shape, num_accum=2)
    tstats = step.make_train_step(env.tfn, env.tcfgt)(tstate, _tbatch(batch),
                                                      sigma=sigma, eps=eps)
    for k, v in jstats.items():
        assert float(tstats[k]) == pytest.approx(float(v), rel=1e-4), k
    assert tstate.cur_nimg == int(jafter.cur_nimg) == 24
    _hold_stepped(_flat(train_state_to_jax(tstate)["params"]),
                  _flat(_numpy_state(jafter)["params"]), _flat(start["params"]), 1, "params")


def _tiny_state(**train_kw):
    cfg = PrecondConfig(img_resolution=8, **MICRO)
    net = NVPrecond(cfg, seed=3).train()
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n.endswith("gain"):
                p.fill_(1.0)
    tc = step.TrainConfig(batch_size=2, ref_lr=LR, rampup_Mimg=0.0, **train_kw)
    return step.init_train_state(net, tc), tc


def test_force_finite_zeroes_a_planted_nan_gradient():
    state, tc = _tiny_state()
    victim = state.names.index("unet.out_conv.weight")
    state.params[victim].register_hook(lambda g: torch.full_like(g, float("nan")))
    before = [p.detach().clone() for p in state.params]
    stats = step.make_train_step(loss.NVLoss(), tc)(
        state, _tbatch(_batches(1, 2, 8, seed=3)[0]), torch.Generator().manual_seed(0))
    assert np.isfinite(float(stats["Grad/global_norm"]))
    assert torch.equal(state.params[victim], before[victim])       # zero gradient: no move
    assert all(bool(torch.isfinite(p).all()) for p in state.params)
    assert sum(not torch.equal(p, b) for p, b in zip(state.params, before)) > len(before) // 2

    state, _ = _tiny_state(force_finite=False)
    state.params[victim].register_hook(lambda g: torch.full_like(g, float("nan")))
    tc = dataclasses.replace(tc, force_finite=False)
    stats = step.make_train_step(loss.NVLoss(), tc)(
        state, _tbatch(_batches(1, 2, 8, seed=3)[0]), torch.Generator().manual_seed(0))
    assert not np.isfinite(float(stats["Grad/global_norm"]))


def test_force_wn_renormalises_every_mpconv_weight():
    state, tc = _tiny_state(force_wn=True)
    step.make_train_step(loss.NVLoss(), tc)(
        state, _tbatch(_batches(1, 2, 8, seed=4)[0]), torch.Generator().manual_seed(0))
    convs = [m for m in state.net.modules() if isinstance(m, MPConv)]
    assert len(convs) > 10
    for m in convs:
        w = m.weight.detach()
        rms = w.flatten(1).square().mean(1).sqrt()
        torch.testing.assert_close(rms, torch.ones_like(rms), rtol=0, atol=2e-4)
    # The JAX transform on the same tree gives the same weights.
    from vivid_tpu.nn.mp import force_weight_normalize as j_force
    from vivid_tpu_torch.compat.from_jax import to_jax
    from vivid_tpu_torch.nn.mp import force_weight_normalize
    net = NVPrecond(PrecondConfig(img_resolution=8, **MICRO), seed=4)
    want = _flat(jax.tree.map(np.asarray, j_force(jax.tree.map(jnp.asarray,
                                                               to_jax(net.state_dict())))))
    force_weight_normalize(net)
    for n, t in net.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[n], rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_remat_modes_give_equal_gradients(dropout):
    """False, True and "save_dots" differ in what the backward pass keeps,
    not in what it computes: bitwise equal gradients, dropout masks included."""
    grads = {}
    batch = _tbatch(_batches(1, 2, 16, seed=5)[0])
    for remat in (False, True, "save_dots"):
        cfg = PrecondConfig(img_resolution=16, extra_attn=1, dropout=dropout,
                            **dict(TINY, remat=remat))
        net = NVPrecond(cfg, seed=5).train()
        with torch.no_grad():
            for n, p in net.named_parameters():
                if n.endswith("gain"):
                    p.fill_(1.0)
        l = loss.NVLoss()(net, batch["src"], batch["tgt"], batch["geometry"],
                          generator=torch.Generator().manual_seed(9))
        l.sum().backward()
        grads[remat] = [p.grad for p in net.parameters()]
        assert all(g is not None for g in grads[remat])
    for remat in (True, "save_dots"):
        for a, b in zip(grads[remat], grads[False]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        cfg = PrecondConfig(img_resolution=16, **dict(TINY, remat="everything"))
        net = NVPrecond(cfg, seed=0).train()
        net(batch["src"], batch["tgt"], torch.ones(2), batch["geometry"])


def test_dropout_is_drawn_from_the_generator_in_training_mode_only():
    cfg = PrecondConfig(img_resolution=16, dropout=0.5, **TINY)
    net = NVPrecond(cfg, seed=1)
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n.endswith("gain"):
                p.fill_(1.0)
    b = _tbatch(_batches(1, 2, 16, seed=6)[0])
    call = lambda seed: net(b["src"], b["tgt"], torch.ones(2), b["geometry"],
                            generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        net.train()
        a, a2, c = call(0), call(0), call(1)
        net.eval()
        e, e2 = call(0), call(1)
    assert torch.equal(a, a2) and not torch.equal(a, c)
    assert torch.equal(e, e2) and not torch.equal(a, e)


def test_train_state_round_trips_through_the_jax_layout():
    env = _setup(uncond=False, res=8, tiny=MICRO)
    rng = np.random.RandomState(0)
    start = _numpy_state(env.state)
    for key in ("adam_m", "adam_v"):
        start[key] = jax.tree.map(lambda x: np.asarray(rng.rand(*x.shape), np.float32), start[key])
    start["adam_step"], start["cur_nimg"] = np.int32(7), np.int32(84)
    back = train_state_to_jax(train_state_from_jax(start, env.tcfg))
    assert int(back["adam_step"]) == 7 and int(back["cur_nimg"]) == 84
    for key in ("params", "adam_m", "adam_v"):
        want, got = _flat(start[key]), _flat(back[key])
        assert set(want) == set(got)
        for n in want:
            if key != "params" and n.endswith(("freqs", "phases")):
                assert not got[n].any()      # the port keeps no moments for buffers
            else:
                np.testing.assert_array_equal(got[n], want[n], err_msg=f"{key} {n}")
    for ema in back["emas"]:
        for n, w in _flat(start["params"]).items():
            np.testing.assert_array_equal(_flat(ema)[n], w, err_msg=n)
