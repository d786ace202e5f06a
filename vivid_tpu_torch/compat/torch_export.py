"""Exporter: the port's NVPrecond -> a reference-format torch snapshot.

The inverse of `compat.torch_pickle`, as vivid_tpu/compat/torch_export.py is
for the JAX package: it writes a `network-snapshot-*.pkl` that the reference
consumes unmodified (`pickle.load`, then `data['ema'].to(device)`). The
pickle is made by instantiating the reference's own
`training.models.NVPrecond`, whose `@persistence.persistent_class` decorator
embeds the defining source in the pickle, so the file has the format of the
reference's training snapshots. The reference checkout is needed at export
time only (`reference_root`); `tools/ref_standin.py` writes a stand-in for
it.

The port's state-dict names and layouts are the reference's, so the state
goes into the reference net with `load_state_dict(strict=True)` as it is.

    python -m vivid_tpu_torch.compat.torch_export IN.pkl OUT.pkl --reference-root=DIR

reads IN.pkl (a snapshot of the port or of the JAX package) with
`train.snapshots.load_snapshot` on the CPU.
"""

import importlib
import os
import pickle
import sys
from typing import Optional

import click
import torch

from vivid_tpu_torch.compat.torch_pickle import _stub_module

# The reference's heavy dependencies that building its model, encoder and
# loss does not use; stubbed while it is imported.
_REF_STUBS = [
    "kornia", "kornia.geometry", "kornia.geometry.transform",
    "kornia.geometry.conversions", "litdata",
    "torchvision", "torchvision.transforms",
    "torchvision.transforms.functional", "torchvision.utils",
    "wandb", "fvcore", "fvcore.nn",
]


def _install_stubs():
    """Attribute-tolerant stubs for the modules of `_REF_STUBS` not already
    imported. Returns the names inserted, so that the caller can take them
    out again: a stub left in sys.modules would shadow a real later import."""
    inserted = []
    for name in _REF_STUBS:
        if name not in sys.modules:
            sys.modules[name] = _stub_module(name)
            inserted.append(name)
    if "kornia" in inserted:
        sys.modules["kornia"].geometry = sys.modules["kornia.geometry"]
        sys.modules["kornia.geometry"].transform = sys.modules["kornia.geometry.transform"]
        sys.modules["kornia.geometry.transform"].resize = lambda *a, **k: None
    return inserted


def import_reference(root: str, module: str = "training.models"):
    """Import `module` of the reference checkout at `root`, its unavailable
    dependencies stubbed for the import only (the module keeps what it
    bound; sys.modules gets its real packages back)."""
    if not os.path.isdir(os.path.join(root, "training")):
        raise FileNotFoundError(
            f"reference checkout not found at {root!r} (need training/models.py)")
    inserted = _install_stubs()
    if root not in sys.path:
        sys.path.insert(0, root)
    try:
        return importlib.import_module(module)
    finally:
        for name in inserted:
            sys.modules.pop(name, None)


def config_to_init_kwargs(cfg) -> dict:
    """PrecondConfig -> the reference NVPrecond's init arguments."""
    return dict(
        img_resolution=cfg.img_resolution,
        img_channels=cfg.img_channels,
        source_label_dim=cfg.source_label_dim,
        target_label_dim=cfg.target_label_dim,
        use_fp16=bool(cfg.use_bf16),          # bf16 here, fp16 there
        sigma_data=cfg.sigma_data,
        logvar_channels=cfg.logvar_channels,
        super_res=cfg.super_res,
        no_time_enc=cfg.no_time_enc,
        depth_input=cfg.depth_input,
        warp_depth_coor=cfg.warp_depth_coor,
        uncond=cfg.uncond,
        noisy_sr=cfg.noisy_sr,
        model_channels=cfg.model_channels,
        channel_mult=list(cfg.channel_mult),
        channel_mult_noise=cfg.channel_mult_noise,
        channel_mult_emb=cfg.channel_mult_emb,
        num_blocks=cfg.num_blocks,
        attn_resolutions=list(cfg.attn_resolutions),
        extra_attn=cfg.extra_attn,
        epipolar_attention_bias=cfg.epipolar_attention_bias,
        channels_per_head=cfg.channels_per_head,
        dropout=cfg.dropout,
    )


def build_reference_net(state, cfg, reference_root: str):
    """The reference NVPrecond for `cfg` with the port's state dict `state`
    loaded (strict, no layout change): fp32, eval mode, on the CPU."""
    models = import_reference(reference_root)
    net = models.NVPrecond(**config_to_init_kwargs(cfg))
    want = net.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise ValueError(
            f"the state does not cover the reference net: missing "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''}, "
            f"unexpected {extra[:8]}{'...' if len(extra) > 8 else ''}")
    for k, v in state.items():
        if tuple(want[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: ours {tuple(v.shape)}, "
                             f"reference {tuple(want[k].shape)}")
    net.load_state_dict({k: v.detach().float().cpu() for k, v in state.items()}, strict=True)
    return net.eval().requires_grad_(False)


def build_reference_aux(cfg, reference_root: str, loss_kwargs: Optional[dict] = None):
    """The reference's own encoder and loss objects (persistent classes, so
    that pickling them embeds their source as reference snapshots do).
    Returns (encoder, loss_fn)."""
    encoders = import_reference(reference_root, "training.encoders")
    loop = import_reference(reference_root, "training.training_loop")
    loss_cls = loop.SRNVLoss if cfg.super_res else loop.NVLoss
    kw = {k: v for k, v in dict(loss_kwargs or {}).items()
          if k in ("P_mean", "P_std", "sigma_data")}
    return encoders.StandardRGBEncoder(), loss_cls(**kw)


def export_reference_pickle(path: str, state, cfg, reference_root: str,
                            dataset_kwargs: Optional[dict] = None,
                            loss_kwargs: Optional[dict] = None,
                            fp16: bool = True, embed_aux: bool = True) -> str:
    """Write a reference-format snapshot of the port's state dict `state`
    (an NVPrecond's, for `cfg`) at `path`: dict(encoder, dataset_kwargs,
    loss_fn, ema), as the reference's snapshot writer makes it, the net
    stored fp16 (`fp16=False` keeps fp32). With `embed_aux=False` the
    encoder and loss_fn entries are None, which the reference's loader
    accepts (it builds the encoder itself)."""
    net = build_reference_net(state, cfg, reference_root)
    if fp16:
        net = net.to(torch.float16)
    encoder = loss_fn = None
    if embed_aux:
        encoder, loss_fn = build_reference_aux(cfg, reference_root, loss_kwargs)
    data = dict(encoder=encoder, dataset_kwargs=dict(dataset_kwargs or {}),
                loss_fn=loss_fn, ema=net)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


@click.command(help="Convert a training snapshot into a reference-format torch pickle: "
                    "python -m vivid_tpu_torch.compat.torch_export IN.pkl OUT.pkl "
                    "--reference-root=DIR")
@click.argument("snapshot", type=click.Path(exists=True, dir_okay=False))
@click.argument("out", type=click.Path(dir_okay=False))
@click.option("--reference-root", required=True,
              help="A reference checkout (needed at export time only; the pickle "
                   "written stands alone).")
@click.option("--fp16/--fp32", default=True, show_default=True,
              help="Store the weights fp16, as reference snapshots do.")
def cmdline(snapshot, out, reference_root, fp16):
    from vivid_tpu_torch.train.snapshots import load_snapshot
    data = load_snapshot(snapshot, device="cpu")
    export_reference_pickle(out, data.net.state_dict(), data.cfg,
                            reference_root=reference_root,
                            dataset_kwargs=data.dataset_kwargs,
                            loss_kwargs=data.get("loss_kwargs"), fp16=fp16)
    click.echo(f"Wrote reference-format snapshot: {out}")


if __name__ == "__main__":
    cmdline()
