"""Inference snapshots in the JAX package's `vivid_tpu.snapshot.v1` format.

A snapshot is a pickle of plain data: dict(format, ema=<nested dict of
numpy arrays in the JAX tree layout>, model_cfg=<PrecondConfig fields>,
encoder, dataset_kwargs, loss_kwargs). Weights are stored fp16 and load as
fp32, so a snapshot either package writes loads in the other.
`load_snapshot` also reads the reference's torch persistence pickles (the
shipped vivid-*.pkl), through `compat.torch_pickle`. Unpickling runs code,
so load only snapshots you trust.
"""

import dataclasses
import os
import pickle

import numpy as np

from vivid_tpu_torch.compat.from_jax import from_jax, to_jax
from vivid_tpu_torch.compat.torch_pickle import (ENCODER, load_reference_module,
                                                 snapshot_from_reference)
from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.core.util import open_url
from vivid_tpu_torch.nn.precond import NVPrecond, PrecondConfig

SNAPSHOT_FORMAT = "vivid_tpu.snapshot.v1"


def _map_tree(tree, fn):
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def save_snapshot(path: str, net: NVPrecond, state=None, dataset_kwargs=None,
                  loss_kwargs=None):
    """Write `net`'s config and weights (fp16): its own state_dict, or
    `state` in its place (the trainer's EMA copies)."""
    data = dict(
        format=SNAPSHOT_FORMAT,
        ema=_map_tree(to_jax(net.state_dict() if state is None else state),
                      lambda a: a.astype(np.float16)),
        model_cfg=dataclasses.asdict(net.cfg),
        encoder=ENCODER,
        dataset_kwargs=dict(dataset_kwargs or {}),
        loss_kwargs=dict(loss_kwargs or {}),
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(data, f)
    os.replace(tmp, path)


def load_snapshot(path: str, device="cpu") -> EasyDict:
    """-> EasyDict(net=NVPrecond on `device` in eval mode, cfg, encoder,
    dataset_kwargs, loss_kwargs). `path` is a local path, a file:// URL or
    an HTTP(S) URL in the download cache (`core.util.open_url`). A pickle
    that is not a v1 snapshot is read as a reference pickle
    (`compat.torch_pickle`); a file that is not a pickle raises ValueError."""
    path = open_url(os.fspath(path), return_filename=True, verbose=False)
    with open(path, "rb") as f:
        head = f.read(1)
    if head != b"\x80":
        raise ValueError(f"{path!r} is not a pickle")
    # The reference reader's unpickler also reads a v1 snapshot, which holds
    # plain data only: one read serves both formats.
    data = load_reference_module(path)
    if not (isinstance(data, dict) and data.get("format") == SNAPSHOT_FORMAT):
        return snapshot_from_reference(data, path, device=device)
    cfg_dict = dict(data["model_cfg"])
    for k in ("channel_mult", "attn_resolutions"):
        if isinstance(cfg_dict.get(k), list):
            cfg_dict[k] = tuple(cfg_dict[k])
    cfg = PrecondConfig(**cfg_dict)
    net = NVPrecond(cfg, device="meta").to_empty(device=device)
    net.load_state_dict(from_jax(data["ema"]), strict=True)
    return EasyDict(net=net.eval().requires_grad_(False), cfg=cfg,
                    encoder=data.get("encoder"),
                    dataset_kwargs=data.get("dataset_kwargs", {}),
                    loss_kwargs=data.get("loss_kwargs", {}))
