"""The port's super-resolution training path against vivid_tpu (CPU, fp32,
tiny): `SRNVLoss` on shared sigma, noise and conditioning noise; a
`vivid-sr`-shaped train step against `make_train_step`, with the port's long
sequence attention route (threshold patched down) on the path; the recompute
modes; a `super_res` train state across the packages; the `vivid-sr` preset;
and the trainer end to end in SR and in single-source (vanilla) mode.

torch cannot reproduce JAX's random bits, so the JAX side's draws are read
off its keys and handed to the port. Tolerances are those of
test_torch_loss.py (elementwise loss: relative L2 1e-4) and
test_torch_train_step.py (gradient leaf: relative L2 1e-3; stepped tensors in
units of the learning rate): fp32 on both sides, sums in another order."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.cli import train_nvs as jcli
from vivid_tpu.diffusion import loss as jloss
from vivid_tpu.diffusion.phema import std_to_exp
from vivid_tpu.nn import precond as jprecond
from vivid_tpu.train import step as jstep
from vivid_tpu_torch.cli import train_nvs
from vivid_tpu_torch.compat.from_jax import from_jax, train_state_from_jax, train_state_to_jax
from vivid_tpu_torch.data import scenes
from vivid_tpu_torch.diffusion import loss
from vivid_tpu_torch.generate import generate_images_nvs
from vivid_tpu_torch.kernels import attention, flash
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train import step
from vivid_tpu_torch.train.loop import training_loop
from vivid_tpu_torch.train.snapshots import load_snapshot

from test_torch_loss import jax_draws
from test_torch_model import TINY, _params
from test_torch_sr import _cond_noise
from test_torch_train_step import (GRAD_REL_L2, LR, _flat, _hold_stepped, _numpy_state, _rel_l2,
                                   _wrapped)

torch.set_num_threads(1)

# The shipped SR model's shape in small: one source, 20/20 labels, extra_attn,
# ch = 16 at 32px. The denoiser (kind 'sr') has 32 channels a head whatever
# the config says, so its only attention is at 16x16 (S = 256, one head).
SR = dict(TINY, img_resolution=32, super_res=True, num_sources=1, source_label_dim=20,
          target_label_dim=20, extra_attn=1)


def _batch(b, res, seed):
    rng = np.random.RandomState(seed)
    return dict(src=rng.randn(b, 1, res, res, 3).astype(np.float32),
                tgt=rng.randn(b, res, res, 3).astype(np.float32),
                geometry=rng.randn(b, 1, 20).astype(np.float32))


def _sr_draws(jfn, key, shape):
    """sigma, unit noise and unit conditioning noise as jloss.SRNVLoss and
    precond_apply draw them from `key`."""
    sigma, eps = jax_draws(jfn, key, shape)
    cond = _cond_noise(jax.random.split(key, 3)[2], shape)
    return tuple(torch.from_numpy(np.array(a)) for a in (sigma, eps, cond))


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("noisy_sr", [0.0, 0.25])
def test_srnvloss_matches_jax(noisy_sr):
    jcfg = jprecond.PrecondConfig(noisy_sr=noisy_sr, **SR)
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 11)
    batch = _batch(2, 32, 11)
    jfn = jloss.SRNVLoss(P_mean=-0.8, P_std=1.6)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda p: jfn(p, jcfg, key, batch["src"], batch["tgt"],
                                            batch["geometry"], train=True))(params))
    sigma, eps, cond = _sr_draws(jfn, key, batch["tgt"].shape)
    net = NVPrecond(PrecondConfig(**dataclasses.asdict(jcfg)))
    net.load_state_dict(from_jax(params), strict=True)
    tfn = loss.SRNVLoss(P_mean=-0.8, P_std=1.6)
    tb = _tb(batch)
    with torch.no_grad():
        got = tfn(net.train(), tb["src"], tb["tgt"], tb["geometry"], sigma=sigma, eps=eps,
                  cond_noise=cond if noisy_sr else None)
        assert got.shape == want.shape == (2, 32, 32, 3)
        assert _rel_l2(got.numpy(), want) <= 1e-4
        if noisy_sr:   # the conditioning noise is part of the function
            other = tfn(net, tb["src"], tb["tgt"], tb["geometry"], sigma=sigma, eps=eps,
                        cond_noise=torch.zeros_like(cond))
            assert _rel_l2(other.numpy(), want) > 1e-2


def test_srnvloss_does_not_honour_plain_mse():
    """As in the JAX class: plain_mse is accepted and the learned-variance
    form is returned all the same."""
    jcfg = jprecond.PrecondConfig(noisy_sr=0.25, **SR)
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 12)
    batch = _batch(2, 32, 12)
    key = jax.random.PRNGKey(8)
    jfn = jloss.SRNVLoss(plain_mse=True)
    want = np.asarray(jax.jit(lambda p: jfn(p, jcfg, key, batch["src"], batch["tgt"],
                                            batch["geometry"]))(params))
    net = NVPrecond(PrecondConfig(**dataclasses.asdict(jcfg)))
    net.load_state_dict(from_jax(params), strict=True)
    sigma, eps, cond = _sr_draws(jfn, key, batch["tgt"].shape)
    tb = _tb(batch)
    with torch.no_grad():
        outs = [fn(net.train(), tb["src"], tb["tgt"], tb["geometry"], sigma=sigma, eps=eps,
                   cond_noise=cond)
                for fn in (loss.SRNVLoss(plain_mse=True), loss.SRNVLoss())]
    assert want.shape == outs[0].shape == (2, 32, 32, 3)
    assert torch.equal(outs[0], outs[1])
    assert _rel_l2(outs[0].numpy(), want) <= 1e-4


def test_srnvloss_draws_the_conditioning_noise_on_every_call():
    """One generator feeds sigma, eps and the conditioning noise: the same
    seed repeats the loss, and a second call on the same generator sees
    another conditioning image (unlike a sampling run, which draws once)."""
    net = NVPrecond(PrecondConfig(noisy_sr=0.25, **SR), seed=0).train()
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n.endswith("gain"):
                p.fill_(1.0)
    fn = loss.SRNVLoss()
    tb = _tb(_batch(2, 32, 13))
    args = (tb["src"], tb["tgt"], tb["geometry"])
    seen = []
    real = net.forward

    def spy(*a, **kw):
        seen.append(kw["cond_noise"])
        return real(*a, **kw)

    net.forward = spy
    sigma = torch.ones(2)
    eps = torch.zeros(2, 32, 32, 3)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(1)
        a = fn(net, *args, generator=gen)
        fn(net, *args, generator=gen, sigma=sigma, eps=eps)
        fn(net, *args, generator=gen, sigma=sigma, eps=eps)
        b = fn(net, *args, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.equal(seen[0], seen[3])
    assert seen[0].shape == (2, 32, 32, 3) and not torch.equal(seen[1], seen[2])
    assert abs(float(seen[0].std()) - 1.0) < 0.1


@pytest.fixture(scope="module")
def sr_step():
    """One step of both packages from the same `vivid-sr`-shaped state, and
    the gradients of the scalar loss. The port runs it with the long-sequence
    threshold at S = 256, so the denoiser's and the encoder's attention take
    the no-max route and its backward."""
    jcfg = jprecond.PrecondConfig(noisy_sr=0.25, **SR)
    params = _params(lambda k: jprecond.precond_init(k, jcfg), 14)
    kw = dict(batch_size=2, ref_lr=LR, rampup_Mimg=0.0, nimg_mult=1)
    jcfgt, tcfgt = jstep.TrainConfig(**kw), step.TrainConfig(**kw)
    jfn = jloss.SRNVLoss(P_mean=-0.8, P_std=1.6)
    jloss_fn = _wrapped(jfn)
    exps = tuple(float(std_to_exp(s) + 1) for s in jcfgt.ema_stds)
    jstep_fn = jstep.make_train_step(jloss_fn, jcfg, jcfgt, exps)
    state = jstep.init_train_state(jax.tree.map(jnp.asarray, params), jcfgt)
    batch = _batch(2, 32, 14)
    key = jax.random.PRNGKey(21)

    def scalar(p, rng, b):
        l = jloss.clamp_loss(jloss_fn(p, jcfg, rng, b["src"], b["tgt"], b["geometry"]))
        return jnp.sum(l) / b["tgt"].shape[0]

    start = _numpy_state(state)
    jgrads, (jafter, jstats) = jax.jit(
        lambda s, b, k: (jax.grad(scalar)(s.params, k, b), jstep_fn(s, b, k)))(state, batch, key)

    sigma, eps, cond = _sr_draws(jfn, key, batch["tgt"].shape)
    tstate = train_state_from_jax(start, PrecondConfig(**dataclasses.asdict(jcfg)))
    tfn = loss.SRNVLoss(P_mean=-0.8, P_std=1.6)
    tb = _tb(batch)
    calls = []
    real_k6, threshold = flash.flash_nomax, attention.NOMAX_MIN_SQ
    flash.flash_nomax = lambda *a: calls.append(tuple(a[0].shape)) or real_k6(*a)
    attention.NOMAX_MIN_SQ = 256
    try:
        l = loss.clamp_loss(tfn(tstate.net, tb["src"], tb["tgt"], tb["geometry"], sigma=sigma,
                                eps=eps, cond_noise=cond))
        (l.sum() / 2).backward()
        tgrads = {n: p.grad.numpy().copy() for n, p in zip(tstate.names, tstate.params)}
        n_calls = len(calls)
        tstats = step.make_train_step(tfn, tcfgt)(tstate, tb, sigma=sigma, eps=eps,
                                                  cond_noise=cond)
    finally:
        flash.flash_nomax, attention.NOMAX_MIN_SQ = real_k6, threshold
    return dict(start=start, jafter=_numpy_state(jafter), jstats=jstats, tstate=tstate,
                tstats=tstats, jgrads=jax.tree.map(np.asarray, jgrads), tgrads=tgrads,
                calls=calls[:n_calls])


def test_sr_gradients_match_jax_grad(sr_step):
    want = _flat(sr_step["jgrads"])
    got = sr_step["tgrads"]
    assert set(got) == set(want) - {k for k in want if k.endswith(("freqs", "phases"))}
    bad = {n: _rel_l2(g, want[n]) for n, g in got.items() if _rel_l2(g, want[n]) > GRAD_REL_L2}
    assert not bad, bad
    assert np.linalg.norm(got["unet.enc.32x32_conv.weight"][:, 3:6]) > 0   # the conditioning image's
    # Every attention of the tiny model (S = 256) went the long-sequence way:
    # the encoder's (8 channels a head) and the denoiser's (32, with the
    # source's keys after its own).
    assert sorted(set(sr_step["calls"])) == [(2, 1, 256, 32), (2, 4, 256, 8)]
    assert len(sr_step["calls"]) == 4


def test_sr_train_step_matches_make_train_step(sr_step):
    got = train_state_to_jax(sr_step["tstate"])
    want = sr_step["jafter"]
    assert int(got["cur_nimg"]) == int(want["cur_nimg"]) == 2      # nimg_mult 1
    assert int(got["adam_step"]) == int(want["adam_step"]) == 1
    for k, v in sr_step["jstats"].items():
        assert float(sr_step["tstats"][k]) == pytest.approx(float(v), rel=1e-4), k
    before = _flat(sr_step["start"]["params"])
    _hold_stepped(_flat(got["params"]), _flat(want["params"]), before, 1, "params")
    for i in range(2):
        _hold_stepped(_flat(got["emas"][i]), _flat(want["emas"][i]), before, 1, f"ema {i}")


def test_sr_train_state_round_trips_through_the_jax_layout(sr_step):
    """A `super_res` state: the widened first conv, the 20/20 label
    embeddings and the three Fourier buffers cross both ways unchanged."""
    state = sr_step["tstate"]
    tree = train_state_to_jax(state)
    assert tree["params"]["unet"]["enc/32x32_conv"]["w"].shape == (3, 3, 7, 16)
    assert tree["params"]["unet"]["emb_label"]["w"].shape == (20, 32)
    back = train_state_from_jax(tree, state.net.cfg)
    assert back.names == state.names and back.cur_nimg == 2 and back.adam_step == 1
    for key in ("params", "adam_m", "adam_v"):
        for a, b in zip(getattr(back, key), getattr(state, key)):
            assert a.shape == b.shape and torch.equal(a, b)    # 0-dim gains stay 0-dim
    for a, b in zip(back.net.state_dict().items(), state.net.state_dict().items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1])
    # ... so the state that came back can take a step.
    tb = _tb(_batch(2, 32, 16))
    stats = step.make_train_step(loss.SRNVLoss(), step.TrainConfig(batch_size=2))(
        back, tb, torch.Generator().manual_seed(0))
    assert back.adam_step == 2 and np.isfinite(float(stats["Grad/global_norm"]))
    fourier = [n for n in state.net.state_dict() if n.endswith(("freqs", "phases"))]
    assert len(fourier) == 6
    for n in fourier:   # fixed by the step, and no moments of their own
        np.testing.assert_array_equal(_flat(tree["params"])[n], _flat(sr_step["start"]["params"])[n])
        assert not _flat(tree["adam_m"])[n].any()


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_sr_remat_modes_give_equal_gradients(dropout, monkeypatch):
    """kind 'sr' under autograd with dropout: False, True and "save_dots"
    give bitwise equal gradients, through the long-sequence route too."""
    monkeypatch.setattr(attention, "NOMAX_MIN_SQ", 256)
    tb = _tb(_batch(2, 32, 15))
    grads = {}
    for remat in (False, True, "save_dots"):
        cfg = PrecondConfig(noisy_sr=0.25, dropout=dropout, **dict(SR, remat=remat))
        net = NVPrecond(cfg, seed=5).train()
        with torch.no_grad():
            for n, p in net.named_parameters():
                if n.endswith("gain"):
                    p.fill_(1.0)
        l = loss.SRNVLoss()(net, tb["src"], tb["tgt"], tb["geometry"],
                            generator=torch.Generator().manual_seed(9))
        l.sum().backward()
        grads[remat] = [p.grad for p in net.parameters()]
        assert all(g is not None and bool(g.abs().sum() > 0) for g in grads[remat])
    for remat in (True, "save_dots"):
        for a, b in zip(grads[remat], grads[False]):
            assert torch.equal(a, b)


def test_vivid_sr_preset_config_matches_jax():
    """The `vivid-sr` preset, and what `setup_training_config` makes of it,
    key for key; the JAX package's extra keys are features the port lacks
    (`fsdp`, `debug`)."""
    assert dict(train_nvs.config_presets["vivid-sr"]) == dict(jcli.config_presets["vivid-sr"])
    opts = dict(preset="vivid-sr", data="scenes/", status=960, snapshot=10000)
    got = train_nvs.setup_training_config(**opts)
    want = jcli.setup_training_config(**opts)
    assert got.batch_size == 128 and got.sr_training and got.vanilla_mode
    net = dict(want.network_kwargs)
    assert not net["depth_input"] and not net["warp_depth_coor"]
    assert dict(got.network_kwargs) == net
    assert net["super_res"] and net["num_sources"] == 1 and net["target_label_dim"] == 20
    assert net["noisy_sr"] == 0.25 and net["remat"] is True and net["model_channels"] == 64
    for key, value in got.items():
        if key not in ("network_kwargs", "max_steps", "device"):
            assert value == want[key], key
    noisy = train_nvs.setup_training_config(**opts, noisy_sr=0.1)
    assert noisy.network_kwargs.noisy_sr == 0.1


@pytest.fixture(scope="module")
def data32(tmp_path_factory):
    return scenes.make_synthetic_dataset(str(tmp_path_factory.mktemp("sr_train") / "scenes"),
                                         num_scenes=3, num_views=4, imsize=32)


def test_trainer_takes_a_vivid_sr_step_and_its_snapshot_samples(data32, tmp_path):
    """The preset through `setup_training_config` and `launch_training` on
    the CPU at ch = 16. The CLI fixes 256px and the config's 64 channels a
    head, at which ch = 16 leaves the encoder without heads; so the test
    narrows both in `network_kwargs`, and nothing else."""
    c = train_nvs.setup_training_config(
        preset="vivid-sr", data=data32, channels=16, batch=4, batch_gpu=2, bf16=False,
        max_steps=1, status=4, snapshot=4, remat="true", device="cpu")
    c.network_kwargs.update(img_resolution=32, channels_per_head=8)
    c.lr_kwargs.rampup_Mimg = 0.0
    result = train_nvs.launch_training(str(tmp_path / "run"), c)
    state = result.state
    assert state.adam_step == 1 and state.cur_nimg == 4            # nimg_mult 1 in vanilla mode
    assert state.net.cfg.super_res and state.net.cfg.num_sources == 1
    tick = result.ticks[-1]
    assert tick["steps"] == 1 and np.isfinite(tick["loss"]) and tick["grad_norm"] > 0
    log = open(tmp_path / "run" / "log.txt").read()
    assert "in 2 microbatch(es)" in log and "nimg_mult 1" in log
    opts = json.load(open(tmp_path / "run" / "training_options.json"))
    assert opts["sr_training"] and opts["vanilla_mode"]
    snaps = sorted(f for f in os.listdir(tmp_path / "run") if f.endswith(".pkl"))
    assert len(snaps) == 2
    snap = load_snapshot(str(tmp_path / "run" / snaps[0]))
    assert snap.cfg.super_res and snap.cfg.img_resolution == 32
    batches = list(generate_images_nvs(net=snap, vanilla_mode=True, seeds=[0, 1],
                                       max_batch_size=2, num_steps=2, verbose=False,
                                       device="cpu", datakwargs={"path": data32}))
    assert batches[0].images.shape == (2, 32, 32, 3)
    assert bool(torch.isfinite(batches[0].latents).all())


def test_trainer_trains_the_single_source_base_model(data32, tmp_path):
    """`vanilla_mode` with a 64px-style net: one source per pair, labels
    20/20, one image counted per pair."""
    net = dict(TINY, img_resolution=16)
    result = training_loop(run_dir=str(tmp_path), dataset_kwargs={"path": data32},
                           network_kwargs=net, lr_kwargs=dict(ref_lr=0.01, rampup_Mimg=0.0),
                           batch_size=2, vanilla_mode=True, status_nimg=2, snapshot_nimg=None,
                           max_steps=2, device="cpu")
    cfg = result.state.net.cfg
    assert (cfg.num_sources, cfg.target_label_dim, cfg.super_res) == (1, 20, False)
    assert result.state.cur_nimg == 4 and [t["steps"] for t in result.ticks] == [0, 1, 1]
    assert all(np.isfinite(t["loss"]) for t in result.ticks[1:])


def test_trainer_refuses_network_kwargs_that_contradict_the_mode(data32, tmp_path):
    kw = dict(run_dir=str(tmp_path), dataset_kwargs={"path": data32}, device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        training_loop(network_kwargs=dict(TINY, img_resolution=16, super_res=True), **kw)
    with pytest.raises(ValueError, match="disagree"):
        training_loop(network_kwargs=dict(TINY, img_resolution=16, num_sources=1), **kw)
