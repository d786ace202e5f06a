"""Five places where the port had drifted from vivid_tpu, each held to it on
the CPU at a tiny size: a `no_time_enc` model sampled with one encoder pass,
dataset arguments passed on or refused by name, the `Status:` line in the
reference's format, the result records' keys, and `--noisy-sr 0`; and what the
big-S attention wrappers refuse before they launch anything. Then C11, the
save_dots rule for high-resolution convolutions, and C12, the threaded
loader (with the JAX loader's lost rows, C-ref-10, pinned)."""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivid_tpu.diffusion import sampler as jsampler
from vivid_tpu.nn import precond as jprecond
from vivid_tpu_torch.cli import train_nvs
from vivid_tpu_torch.compat.from_jax import from_jax
from vivid_tpu_torch.data import collate, scenes
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
    """`cache_dir` is a key no scene dataset of the port takes: every entry
    that is handed it must say so, not drop it. (`shuffle` played this part
    until the port's `SceneDataset` took the JAX package's keys.)"""
    with pytest.raises(ValueError, match="cache_dir"):
        if entry == "dataset":
            scenes.SceneDataset(data, seed=1, cache_dir="x")
        elif entry == "open":
            open_scene_dataset(data, seed=1, cache_dir="x")
        elif entry == "training_loop":
            training_loop(dataset_kwargs={"path": data, "cache_dir": "x"},
                          **_loop_args(tmp_path, data))
        else:
            generate_images_nvs(snapshot, seeds=[0], device="cpu", verbose=False,
                                datakwargs={"path": data, "cache_dir": "x"})


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


# -- C11: save_dots recomputes the convolutions above VIVID_REMAT_HIRES_AREA ----

def _save_dots_run(monkeypatch, remat, area=None):
    """One forward and backward of a tiny 32px NVPrecond under `remat`, with
    VIVID_REMAT_HIRES_AREA at `area` (unset for None) -> (the gradients,
    [(conv output shape NHWC, bytes, input area, kept)] from the policy's own
    decisions in the forward pass)."""
    from torch.utils import checkpoint as ckpt
    from vivid_tpu_torch.nn import unet
    if area is None:
        monkeypatch.delenv("VIVID_REMAT_HIRES_AREA", raising=False)
    else:
        monkeypatch.setenv("VIVID_REMAT_HIRES_AREA", str(area))
    decisions = []
    policy_of = unet._save_dots_policy

    def recording(hires_area):
        policy = policy_of(hires_area)

        def record(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if op is torch.ops.aten.convolution.default and not ctx.is_recompute:
                x, w = args[0], args[1]
                n, _, h, wd = x.shape
                shape = (n, h, wd, w.shape[0])
                decisions.append((shape, int(np.prod(shape)) * x.element_size(), h * wd,
                                  decision == ckpt.CheckpointPolicy.MUST_SAVE))
            return decision
        return record

    monkeypatch.setattr(unet, "_save_dots_policy", recording)
    cfg = PrecondConfig(img_resolution=32, **dict(TINY, channel_mult=(1, 2, 2), remat=remat))
    net = NVPrecond(cfg, seed=3).train()
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n.endswith("gain"):
                p.fill_(1.0)
    gen = torch.Generator().manual_seed(4)
    src, tgt = torch.randn(2, 2, 32, 32, 3, generator=gen), torch.randn(2, 32, 32, 3, generator=gen)
    out = net(src, tgt, torch.ones(2), torch.randn(2, 2, 20, generator=gen))
    out.square().sum().backward()
    return torch.cat([p.grad.reshape(-1) for p in net.parameters()
                      if p.grad is not None]), decisions


def test_save_dots_recomputes_convs_above_the_hires_area(monkeypatch):
    """ROADMAP C11. At area A the conv outputs that save_dots keeps are those
    it keeps with every conv kept, less the outputs of the convs whose input
    area exceeds A; the default (128 x 128) keeps all of them at 32 px. The
    gradient is the same under every mode."""
    want, _ = _save_dots_run(monkeypatch, False)
    grads, kept = {}, {}
    for area in (None, 10 ** 9, 256, 64):
        grads[area], decisions = _save_dots_run(monkeypatch, "save_dots", area)
        limit = 128 * 128 if area is None else area
        assert decisions and all(keep == (a <= limit) for _, _, a, keep in decisions)
        kept[area] = sum(nbytes for _, nbytes, _, keep in decisions if keep)
        every = sum(nbytes for _, nbytes, _, _ in decisions)
        assert kept[area] == every - sum(nbytes for _, nbytes, a, _ in decisions if a > limit)
    assert kept[None] == kept[10 ** 9] > kept[256] > kept[64] > 0
    grads[True], _ = _save_dots_run(monkeypatch, True)
    for area, g in grads.items():
        assert ((g - want).norm() / want.norm()).item() <= 1e-6, area


def test_save_dots_drops_the_conv_outputs_jax_drops(monkeypatch):
    """The conv outputs the port recomputes at areas 256 and 64 have the
    shapes of the residuals that `vivid_tpu` stops saving at the same
    threshold (`jax.ad_checkpoint.saved_residuals`, "mpconv_out_hires")."""
    import collections
    from jax._src.ad_checkpoint import saved_residuals
    from vivid_tpu.nn import mp as jmp
    cfg = jprecond.PrecondConfig(img_resolution=32, **dict(TINY, channel_mult=(1, 2, 2),
                                                            remat="save_dots"))
    params = jprecond.precond_init(jax.random.PRNGKey(0), cfg)
    args = (jnp.ones((2, 2, 32, 32, 3)), jnp.ones((2, 32, 32, 3)), jnp.ones((2,)),
            jnp.zeros((2, 2, 20)))

    def residuals(area):
        monkeypatch.setattr(jmp, "REMAT_HIRES_AREA", area)
        fn = lambda p: jprecond.precond_apply(p, cfg, *args).sum()
        return collections.Counter(tuple(a.shape) for a, _ in saved_residuals(fn, params))

    every = residuals(10 ** 9)
    for area in (256, 64):
        _, decisions = _save_dots_run(monkeypatch, "save_dots", area)
        dropped = collections.Counter(shape for shape, _, _, keep in decisions if not keep)
        assert dropped and dropped == every - residuals(area), area


# -- C12: the threaded loader ----------------------------------------------------

class _ThreeRows:
    """A collate that makes three rows a scene, each naming its scene and
    place, slowly enough that threads interleave."""

    def sample_plan(self, scene):
        return [(scene, i) for i in range(3)]

    def materialize(self, scene, plan):
        import time
        time.sleep(0.002 * (1 + scene % 3))
        return [{"row": np.array(3 * s + i)} for s, i in plan]

    def rows_from_scene(self, scene):
        return self.materialize(scene, self.sample_plan(scene))


def _probe(loader_cls, **kw):
    """7 scenes of 3 rows at batch 4 -> (valid rows, batches)."""
    batches = list(loader_cls(iter(range(7)), _ThreeRows(), batch_size=4, **kw))
    return [int(r) for b in batches for r in b["row"][b["valid"]]], len(batches)


def test_threaded_loader_delivers_every_row_once():
    """ROADMAP C12 and C-ref-10: 21 rows at batch 4 come out in stream order,
    each once, in 5 full batches and one padded tail, for any thread count."""
    for threads in (1, 2, 5):
        for _ in range(3):
            assert _probe(collate.BatchLoader, num_threads=threads) == (list(range(21)), 6)


def test_jax_threaded_loader_loses_rows():
    """C-ref-10, the defect of `vivid_tpu`'s loader that the port does not
    copy: with two threads each keeps and pads its own rows, and the first to
    see the end stops the stream, so rows of the other are lost."""
    from vivid_tpu.data.collate import BatchLoader as JBatchLoader
    runs = [_probe(JBatchLoader, num_threads=2, prefetch=8) for _ in range(5)]
    assert all(len(set(rows)) == len(rows) for rows, _ in runs)
    assert any(len(rows) < 21 for rows, _ in runs), runs


@pytest.fixture(scope="module")
def loader_scenes(tmp_path_factory):
    return scenes.make_synthetic_dataset(str(tmp_path_factory.mktemp("loader")), num_scenes=6,
                                         num_views=6, imsize=16, seed=2)


@pytest.mark.parametrize("threads", [1, 2, 5])
@pytest.mark.parametrize("skip_rows", [0, 5])
def test_threaded_loader_batches_equal_one_thread(loader_scenes, threads, skip_rows):
    """ROADMAP C12: the batches of a finite stream, tail included, are the
    one-thread loader's bit for bit, with and without `skip_rows`."""
    import itertools

    def batches(n):
        stream = itertools.islice(iter(scenes.SceneDataset(loader_scenes, seed=1)), 15)
        return list(collate.BatchLoader(stream, collate.DualSourceCollate(16, seed=3),
                                        batch_size=4, num_threads=n, skip_rows=skip_rows))

    want, got = batches(1), batches(threads)
    assert len(got) == len(want) == -(-(15 - skip_rows) // 4)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_loader_threads_default(monkeypatch):
    monkeypatch.setenv("VIVID_LOADER_THREADS", "3")
    assert collate.default_loader_threads() == 3
    monkeypatch.delenv("VIVID_LOADER_THREADS")
    assert collate.default_loader_threads() == min(4, os.cpu_count() or 1) + 1
