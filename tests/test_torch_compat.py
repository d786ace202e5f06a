"""The port's reference-pickle reader and exporter against vivid_tpu's, on
the CPU: the persistence-protocol reader on the JAX suite's hand-made
pickle, extract_config, the state check, pickles exported through a
stand-in reference checkout (tiny NVPrecond, fp32 and fp16) read by both
packages, the exporter's command line, and, where a reference checkout is
present, an export through the reference's own classes."""

import dataclasses
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from vivid_tpu.compat import torch_pickle as jpickle
from vivid_tpu.nn import precond as jprecond
from vivid_tpu.train import snapshots as jsnapshots
from vivid_tpu_torch.compat import torch_export, torch_pickle
from vivid_tpu_torch.compat.from_jax import from_jax, to_jax
from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig
from vivid_tpu_torch.tools.ref_standin import write_reference_standin
from vivid_tpu_torch.train.snapshots import load_snapshot, save_snapshot

from test_compat import _make_reference_pickle
from test_golden_export import REFERENCE
from test_torch_model import TINY, _close, _params

torch.set_num_threads(1)

NET = dict(TINY, img_resolution=16, extra_attn=1)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_protocol_reader_matches_jax(tmp_path):
    """The JAX suite's hand-made pickle (an embedded TinyNet): the same
    class, state and dataset_kwargs from both readers, each from its own
    execution of the embedded source."""
    path = _make_reference_pickle(tmp_path)
    ours, theirs = torch_pickle.load_reference_module(path), jpickle.load_reference_module(path)
    assert sorted(ours) == sorted(theirs) == ["dataset_kwargs", "ema"]
    assert ours["dataset_kwargs"] == theirs["dataset_kwargs"] == {"path": "/x"}
    a, b = ours["ema"], theirs["ema"]
    assert type(a).__name__ == type(b).__name__ == "TinyNet"
    assert type(a) is not type(b) and type(a).__module__.endswith(".embedded")
    assert a.init_kwargs == b.init_kwargs == {"img_resolution": 64}
    assert sorted(vars(a)) == sorted(vars(b))


class _Net:
    def __init__(self, **attrs):
        self.__dict__.update(attrs)


@pytest.mark.parametrize("net", [
    _Net(init_kwargs=dict(img_resolution=64, model_channels=128, channel_mult=[1, 2, 3, 4],
                          attn_resolutions=[16, 8], extra_attn=1, uncond=True, use_fp16=True)),
    _Net(_init_kwargs=dict(img_resolution=256, super_res=True, target_label_dim=20,
                           model_channels=64, noisy_sr=0.25, depth_input=True)),
    _Net(img_resolution=32, img_channels=3),
], ids=["init_kwargs", "state_field", "no_kwargs"])
def test_extract_config_matches_jax(net):
    got = torch_pickle.extract_config(net)
    assert got == jpickle.extract_config(net)
    assert PrecondConfig(**got) == PrecondConfig(**dataclasses.asdict(
        jprecond.PrecondConfig(**got)))


def test_verify_state_against_config_names_the_problems():
    cfg = PrecondConfig(**NET)
    state = NVPrecond(cfg, device="meta").state_dict()
    torch_pickle.verify_state_against_config(state, cfg)
    state = dict(state)
    del state["unet.out_gain"]
    state["unet.extra.weight"] = torch.zeros(2)
    state["logvar_linear.weight"] = torch.zeros(1, 64)
    with pytest.raises(ValueError, match="3 problems") as err:
        torch_pickle.verify_state_against_config(state, cfg, origin="x.pkl")
    text = str(err.value)
    assert "x.pkl" in text and "missing entry unet.out_gain" in text
    assert "unexpected entry unet.extra.weight" in text
    assert "shape mismatch logvar_linear.weight: got (1, 64), want (1, 128)" in text


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """A stand-in reference checkout; its packages leave sys.modules and its
    root sys.path afterwards."""
    root = write_reference_standin(str(tmp_path_factory.mktemp("reference")))
    yield root
    for name in list(sys.modules):
        if name.split(".")[0] in ("training", "torch_utils"):
            del sys.modules[name]
    if root in sys.path:
        sys.path.remove(root)


@pytest.fixture(scope="module")
def tiny():
    """JAX parameters and config of a tiny dual-source NVPrecond, and the
    port's net on them."""
    cfg = jprecond.PrecondConfig(**NET)
    params = _params(lambda k: jprecond.precond_init(k, cfg), 4)
    net = NVPrecond(PrecondConfig(**dataclasses.asdict(cfg)))
    net.load_state_dict(from_jax(params), strict=True)
    return params, cfg, net.eval()


def _d_x(net_or_params, cfg, jax_side=False):
    rng = np.random.RandomState(2)
    args = (rng.randn(2, 2, 16, 16, 3).astype(np.float32),
            rng.randn(2, 16, 16, 3).astype(np.float32),
            np.array([0.3, 2.5], np.float32), rng.randn(2, 2, 20).astype(np.float32))
    if jax_side:
        return np.asarray(jax.jit(lambda p, *a: jprecond.precond_apply(p, cfg, *a))(
            net_or_params, *args))
    with torch.no_grad():
        return net_or_params(*map(torch.from_numpy, args)).numpy()


@pytest.mark.parametrize("fp16", [False, True])
def test_exported_pickle_loads_in_both_packages(standin, tiny, tmp_path, fp16):
    params, jcfg, net = tiny
    path = str(tmp_path / "network-snapshot-export.pkl")
    torch_export.export_reference_pickle(path, net.state_dict(), net.cfg, reference_root=standin,
                                         dataset_kwargs={"path": "/data/x"},
                                         loss_kwargs=dict(P_mean=-0.8, P_std=1.6), fp16=fp16)
    raw = torch_pickle.load_reference_module(path)
    # The embedded source ran in a module of its own, its decorator stubbed.
    assert type(raw["ema"]).__name__ == "NVPrecond"
    assert type(raw["ema"]).__module__.endswith(".embedded")
    assert raw["ema"]._init_kwargs["use_fp16"] is False
    assert (raw["loss_fn"].P_mean, raw["loss_fn"].P_std) == (-0.8, 1.6)
    assert next(raw["ema"].parameters()).dtype == (torch.float16 if fp16 else torch.float32)

    ours = load_snapshot(path)
    theirs = jpickle.load_reference_pickle(path)
    assert jsnapshots.load_snapshot(path).cfg == theirs.cfg
    assert dataclasses.asdict(ours.cfg) == dataclasses.asdict(theirs.cfg)
    assert ours.dataset_kwargs == theirs.dataset_kwargs == {"path": "/data/x"}
    assert ours.encoder == theirs.encoder and not ours.net.training
    # The JAX package's parameters are the port's, bit for bit.
    got, want = _flat(to_jax(ours.net.state_dict())), _flat(theirs.params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    state = net.state_dict()
    for k, v in ours.net.state_dict().items():
        ref = state[k].half().float() if fp16 else state[k]
        torch.testing.assert_close(v, ref, rtol=0, atol=0, msg=k)
    # D_x of both packages on what they loaded, in fp32.
    cfg32 = dataclasses.replace(theirs.cfg, use_bf16=False)
    ours.net.cfg = dataclasses.replace(ours.cfg, use_bf16=False)
    _close(_d_x(ours.net, None), _d_x(theirs.params, cfg32, jax_side=True))


def test_export_cmdline(standin, tiny, tmp_path):
    """A v1 snapshot through `python -m vivid_tpu_torch.compat.torch_export`
    to an fp32 reference pickle, which loads back to the same weights."""
    _, _, net = tiny
    v1, out = str(tmp_path / "v1.pkl"), str(tmp_path / "ref.pkl")
    save_snapshot(v1, net, dataset_kwargs={"path": "scenes/"}, loss_kwargs={"P_mean": -0.8})
    torch_export.cmdline([v1, out, "--reference-root", standin, "--fp32"],
                         standalone_mode=False)
    with open(out, "rb") as f:
        assert f.read(1) == b"\x80"
    a, b = load_snapshot(v1), load_snapshot(out)
    assert b.dataset_kwargs == {"path": "scenes/"}
    for k, v in a.net.state_dict().items():
        torch.testing.assert_close(b.net.state_dict()[k], v, rtol=0, atol=0, msg=k)
    with pytest.raises(FileNotFoundError, match="reference checkout not found"):
        torch_export.cmdline([v1, out, "--reference-root", str(tmp_path)],
                             standalone_mode=False)


def test_load_snapshot_refuses_what_is_not_a_snapshot(tmp_path):
    path = tmp_path / "x.pkl"
    path.write_bytes(b"not a pickle")
    with pytest.raises(ValueError, match="not a pickle"):
        load_snapshot(str(path))
    with open(path, "wb") as f:
        pickle.dump({"format": "other"}, f)
    with pytest.raises(ValueError, match="no 'ema' or 'net'"):
        load_snapshot(str(path))


def test_export_refuses_a_state_of_other_names(standin, tiny):
    _, _, net = tiny
    state = dict(net.state_dict())
    state["unet.extra"] = state.pop("unet.out_gain")
    with pytest.raises(ValueError, match="missing.*unet.out_gain.*unexpected.*unet.extra"):
        torch_export.build_reference_net(state, net.cfg, standin)


@pytest.mark.skipif(not os.path.isdir(os.path.join(REFERENCE, "training")),
                    reason="reference tree not mounted")
def test_export_through_the_reference(tiny, tmp_path):
    """The reference's own NVPrecond takes the port's state as it is, and
    its forward agrees with the port's on what the port reads back."""
    params, jcfg, net = tiny
    path = str(tmp_path / "ref.pkl")
    torch_export.export_reference_pickle(path, net.state_dict(), net.cfg,
                                         reference_root=REFERENCE, fp16=False)
    ours = load_snapshot(path)
    want = _flat(jpickle.load_reference_pickle(path).params)
    got = _flat(to_jax(ours.net.state_dict()))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert isinstance(ours, EasyDict)
