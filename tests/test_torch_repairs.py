"""Five places where the port had drifted from vivid_tpu, each held to it on
the CPU at a tiny size: a `no_time_enc` model sampled with one encoder pass,
dataset arguments passed on or refused by name, the `Status:` line in the
reference's format, the result records' keys, and `--noisy-sr 0`; and what the
big-S attention wrappers refuse before they launch anything."""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from vivid_tpu.diffusion import sampler as jsampler
from vivid_tpu.nn import precond as jprecond
from vivid_tpu_torch.cli import train_nvs
from vivid_tpu_torch.compat.from_jax import from_jax
from vivid_tpu_torch.data import scenes
from vivid_tpu_torch.diffusion import sampler
from vivid_tpu_torch.generate import generate_images_nvs, open_scene_dataset
from vivid_tpu_torch.kernels import flash
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.train import snapshots
from vivid_tpu_torch.train.loop import training_loop

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1,
            attn_resolutions=(8,), channels_per_head=8, use_bf16=False,
            remat=False)
SIGMA_MAX = 2.0   # a 2-step run from sigma 80 ends near 80: the tolerance is absolute


def _params(cfg, seed):
    """Numpy-seeded JAX tree for `cfg`, with non-zero gains; a small out_gain
    keeps D_x near the data range, as a trained net's."""
    rng = np.random.RandomState(seed)

    def leaf(name, shape):
        if name == "out_gain":
            return rng.uniform(0.1, 0.3, shape)
        if name.endswith("gain"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.randn(*shape)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v.shape).astype(np.float32)
                for k, v in node.items()}
    return walk(jax.eval_shape(lambda k: jprecond.precond_init(k, cfg), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def no_time_enc():
    """A tiny `no_time_enc` model in both packages with the same weights, its
    inputs, and vivid_tpu's 2-step sample of them."""
    cfg = jprecond.PrecondConfig(img_resolution=16, no_time_enc=True, **TINY)
    params = _params(cfg, 0)
    rng = np.random.RandomState(5)
    src = rng.randn(2, 2, 16, 16, 3).astype(np.float32)
    geo = rng.randn(2, 2, 20).astype(np.float32)
    noise = rng.randn(2, 16, 16, 3).astype(np.float32)

    @jax.jit
    def run(params, src, geo, noise):
        den = jsampler.make_denoiser(params, cfg, src=src, geometry=geo)
        return jsampler.edm_sampler(den, noise, num_steps=2, sigma_max=SIGMA_MAX)

    want = np.asarray(run(params, src, geo, noise))
    assert np.isfinite(want).all()
    net = NVPrecond(PrecondConfig(**dataclasses.asdict(cfg)))
    net.load_state_dict(from_jax(params), strict=True)
    return net.eval(), src, geo, noise, want


# The tolerance of tests/test_torch_sampler.py: fp32 on both sides, the sums in
# another order.
@pytest.mark.parametrize("precompute,encoder_calls", [(None, 1), (False, 3)])
def test_no_time_enc_sampler_matches_jax_and_encodes_once(no_time_enc, precompute,
                                                          encoder_calls):
    net, src, geo, noise, want = no_time_enc
    calls = []
    hook = net.encoder.register_forward_hook(lambda *a: calls.append(1))
    try:
        den = sampler.make_denoiser(net, torch.from_numpy(src), torch.from_numpy(geo),
                                    precompute_features=precompute)
        got = sampler.edm_sampler(den, torch.from_numpy(noise), num_steps=2,
                                  sigma_max=SIGMA_MAX)
    finally:
        hook.remove()
    assert len(calls) == encoder_calls      # 2 steps are 3 evaluations
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_features_returned_and_injected_match_jax(no_time_enc):
    net, src, geo, noise, _ = no_time_enc
    cfg = jprecond.PrecondConfig(**dataclasses.asdict(net.cfg))
    params = _params(cfg, 0)
    sigma = np.full((2,), 1.5, np.float32)
    want_feats = jprecond.precond_apply(params, cfg, src, noise, sigma, geo,
                                        return_features=True)
    want = jprecond.precond_apply(params, cfg, src, noise, sigma, geo,
                                  inject_features=want_feats)
    t = torch.from_numpy
    with torch.no_grad():
        feats = net(t(src), t(noise), t(sigma), t(geo), return_features=True)
        got = net(None, t(noise), t(sigma), t(geo), inject_features=feats)
    assert len(feats) == len(want_feats)
    for a, w in zip(feats, want_feats):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return scenes.make_synthetic_dataset(str(tmp_path_factory.mktemp("repairs") / "scenes"),
                                         num_scenes=3, num_views=4, imsize=16)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("repairs_net") / "net.pkl")
    net = NVPrecond(PrecondConfig(img_resolution=16, **TINY), seed=0)
    with torch.no_grad():
        net.unet.out_gain.fill_(0.2)
    snapshots.save_snapshot(path, net)
    return path


def _loop_args(run_dir, data):
    net = dict(img_resolution=16, **TINY)
    return dict(run_dir=str(run_dir), network_kwargs=net,
                loss_kwargs=dict(P_mean=-0.8, P_std=1.6),
                lr_kwargs=dict(ref_lr=0.01, rampup_Mimg=0.0), seed=3, batch_size=2,
                status_nimg=12, snapshot_nimg=None, max_steps=2, device="cpu")


@pytest.mark.parametrize("entry", ["dataset", "open", "training_loop", "generate"])
def test_unknown_dataset_key_raises(entry, data, snapshot, tmp_path):
    """`shuffle` is a key of vivid_tpu's dataset that the port's does not take
    yet: every entry that is handed it must say so, not drop it."""
    with pytest.raises(ValueError, match="shuffle"):
        if entry == "dataset":
            scenes.SceneDataset(data, seed=1, shuffle=False)
        elif entry == "open":
            open_scene_dataset(data, seed=1, shuffle=False)
        elif entry == "training_loop":
            training_loop(dataset_kwargs={"path": data, "shuffle": False},
                          **_loop_args(tmp_path, data))
        else:
            generate_images_nvs(snapshot, seeds=[0], device="cpu", verbose=False,
                                datakwargs={"path": data, "shuffle": False})


def test_known_dataset_keys_pass(data, snapshot):
    """`path` and `seed` are taken; `class_name` is dropped by both packages."""
    assert len(open_scene_dataset(data, seed=1)) == 3
    images = generate_images_nvs(snapshot, seeds=[0], device="cpu", verbose=False,
                                 datakwargs={"path": data, "class_name": "x"}, num_steps=2)
    assert len(images) == 1


def _reference_status_pattern():
    """One regular expression from the format string of vivid_tpu's `Status:`
    line (vivid_tpu/train/loop.py): every literal kept, every `{expr:<W.Pf}`
    a left-aligned number of P decimals, every `{expr:<Ws}` a padded string;
    a group per field, named f0, f1, ..., and their widths."""
    text = open(os.path.join(REPO, "vivid_tpu", "train", "loop.py")).read()
    start = text.index('f"Status: kimg')
    end = text.index('")', text.index("sec/tick", start)) + 1
    pieces = re.findall(r'f"([^"]*)"', text[start:end])
    fmt = "".join(pieces)
    assert fmt.startswith("Status: kimg {") and "sec/tick" in fmt
    pattern, widths, pos = "", [], 0
    for m in re.finditer(r"\{[^{}:]+:<(\d+)(?:\.(\d+)f|s)\}", fmt):
        pattern += re.escape(fmt[pos:m.start()])
        width, decimals = int(m.group(1)), m.group(2)
        body = rf"(?:-?\d+\.\d{{{decimals}}}|nan|inf) *?" if decimals else rf".{{{width},}}?"
        pattern += f"(?P<f{len(widths)}>{body})"
        widths.append(width)
        pos = m.end()
    return pattern + re.escape(fmt[pos:]), widths


def test_status_line_has_the_reference_fields_first(data, tmp_path):
    result = training_loop(dataset_kwargs={"path": data}, **_loop_args(tmp_path, data))
    pattern, widths = _reference_status_pattern()
    assert len(widths) == 4      # kimg, loss, time, sec/tick
    status = [l for l in open(tmp_path / "log.txt").read().splitlines()
              if l.startswith("Status:")]
    assert len(status) == len(result.ticks) == 3
    pattern += r" gnorm \S+ +lr \S+ *$"         # the port's own fields come after
    for line in status:
        m = re.match(pattern, line)
        assert m, (pattern, line)
        for i, width in enumerate(widths):      # left-aligned to the reference's width
            field = m.group(f"f{i}")
            assert len(field) == max(width, len(field.rstrip())), (i, field)
    last = re.match(pattern, status[-1])
    assert float(last.group("f0")) == pytest.approx(result.ticks[-1]["nimg"] / 1e3, abs=0.05)
    assert float(last.group("f1")) == pytest.approx(result.ticks[-1]["loss"], abs=1e-4)


def test_records_have_the_reference_keys(data, snapshot):
    records = list(generate_images_nvs(snapshot, seeds=[3, 4], device="cpu", verbose=False,
                                       datakwargs={"path": data}, num_steps=2))
    assert len(records) == 1
    r = records[0]
    for key in ("images", "src", "tgt", "labels", "noise", "batch_idx", "num_batches",
                "indices", "seeds"):       # vivid_tpu/generate.py's record
        assert key in r, key
    assert r.labels is None and r.noise is None
    assert r.latents.shape == (2, 16, 16, 3) and r.images.shape == (2, 16, 16, 3)


@pytest.mark.parametrize("flags,want", [((), 0.25), (("--noisy-sr", "0"), 0.0),
                                        (("--noisy-sr", "0.1"), 0.1)])
@pytest.mark.parametrize("preset", ["vivid-sr", "vivid-base"])
def test_noisy_sr_zero_switches_the_noise_off(preset, flags, want, capsys):
    import json
    train_nvs.cmdline(["--data", "scenes/", "--preset", preset, "--dry-run", *flags],
                      standalone_mode=False)
    text = capsys.readouterr().out
    cfg = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert cfg["network_kwargs"]["noisy_sr"] == want
    assert type(cfg["network_kwargs"]["noisy_sr"]) is float


def _bhsd(b=1, h=2, sq=8, sk=12, d=32, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, h, sq, d, generator=g).to(dtype)
    k = torch.randn(b, h, sk, d, generator=g).to(dtype)
    v = torch.randn(b, h, sk, d, generator=g).to(dtype)
    return q, k, v


def _misaligned(t):
    """The same values, contiguous, at a base that is no multiple of 16 bytes."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    start = next(i for i in range(8) if (flat.data_ptr() + t.element_size() * i) % 16)
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


BAD_INPUTS = {
    "d=48": lambda q, k, v: (_bhsd(d=48), None),
    "3 dimensions": lambda q, k, v: ((q[0], k[0], v[0]), None),
    "q not contiguous": lambda q, k, v: ((q.transpose(1, 2).contiguous().transpose(1, 2), k, v),
                                         None),
    "v not contiguous": lambda q, k, v: ((q, k, v.flip(2).transpose(1, 2).contiguous()
                                          .transpose(1, 2)), None),
    "k of another length than v": lambda q, k, v: ((q, k[:, :, :-1].contiguous(), v), None),
    "k of another width": lambda q, k, v: ((q, _bhsd(d=64)[1], v), None),
    "fp32 q": lambda q, k, v: ((q.float(), k, v), None),
    "fp16 k": lambda q, k, v: ((q, k.half(), v), None),
    "bias of the wrong shape": lambda q, k, v: ((q, k, v), torch.zeros(1, 2, 8, 11)),
    "bias without heads": lambda q, k, v: ((q, k, v), torch.zeros(1, 8, 12)),
    "bf16 bias": lambda q, k, v: ((q, k, v), torch.zeros(1, 2, 8, 12, dtype=torch.bfloat16)),
    "bias not contiguous": lambda q, k, v: ((q, k, v), torch.zeros(1, 2, 12, 8).transpose(2, 3)),
    "misaligned q": lambda q, k, v: ((_misaligned(q), k, v), None),
    "misaligned v": lambda q, k, v: ((q, k, _misaligned(v)), None),
    "misaligned bias": lambda q, k, v: ((q, k, v), _misaligned(torch.zeros(1, 2, 8, 12))),
    "no keys": lambda q, k, v: ((q, k[:, :, :0], v[:, :, :0]), None),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_big_s_wrappers_refuse_what_the_kernels_do_not_take(case):
    """The checks every big-S wrapper runs before it launches, on CPU tensors
    (`on_card=False` lets the device through): nothing is launched."""
    (q, k, v), bias = BAD_INPUTS[case](*_bhsd())
    before = dict(flash.launches)
    with pytest.raises(ValueError):
        flash._checked_bhsd(q, k, v, bias, on_card=False)
    assert flash.launches == before


def test_big_s_wrappers_take_what_the_kernels_take():
    q, k, v = _bhsd()
    assert flash._checked_bhsd(q, k, v, None, on_card=False) == (1, 2, 8, 12, 32)
    assert flash._checked_bhsd(q, k, v, torch.zeros(1, 2, 8, 12), on_card=False) == (
        1, 2, 8, 12, 32)
    q, k, v = _bhsd(d=64)
    assert flash._checked_bhsd(q, k, v, None, on_card=False)[-1] == 64
    with pytest.raises(ValueError, match="must be on"):      # the card is still required
        flash._checked_bhsd(q, k, v, None)
