"""The benchmark's one door to the program under test, `vivid_tpu_torch`:
its network built from a configuration and handed the benchmark's seeded
weights, its sampling entry, and its kernel launch counters. Nothing else
of the benchmark imports the program.
"""

import torch

from port_bench.reference.model import NetSpec, Precond
from port_bench.weights import seeded_state


def precond_config(spec: NetSpec):
    """The program's PrecondConfig for a configuration file's net."""
    from vivid_tpu_torch.nn.precond import PrecondConfig
    return PrecondConfig(
        img_resolution=spec.resolution, img_channels=spec.img_channels,
        source_label_dim=spec.source_label_dim, target_label_dim=spec.target_label_dim,
        use_bf16=spec.use_bf16, sigma_data=spec.sigma_data,
        logvar_channels=spec.logvar_channels, super_res=spec.super_res, uncond=spec.uncond,
        noisy_sr=spec.noisy_sr, num_sources=spec.num_sources, model_channels=spec.channels,
        channel_mult=spec.channel_mult, num_blocks=spec.num_blocks,
        attn_resolutions=spec.attn_resolutions, extra_attn=spec.extra_attn,
        channels_per_head=spec.channels_per_head, remat=spec.remat)


def reference_shapes(spec: NetSpec):
    """The reference network on the meta device: its state dict's names and
    shapes, no memory."""
    with torch.device("meta"):
        return Precond(spec)


def build_net(spec: NetSpec, seed: int, tag: str, device):
    """The program's NVPrecond with the seeded weights of (seed, tag), as a
    loaded snapshot (EasyDict of net and cfg) for sampling."""
    from vivid_tpu_torch.core.easydict import EasyDict
    from vivid_tpu_torch.nn.precond import NVPrecond
    cfg = precond_config(spec)
    net = NVPrecond(cfg, device="meta").to_empty(device=device)
    net.load_state_dict(seeded_state(reference_shapes(spec), seed, tag, device), strict=True)
    return EasyDict(net=net.eval().requires_grad_(False), cfg=cfg)


def generate(net, gnet, **kwargs):
    """The program's sampling entry (the one behind its generate CLI)."""
    from vivid_tpu_torch.generate import generate_images_nvs
    return generate_images_nvs(net, gnet, **kwargs)


def launches() -> dict:
    """The program's kernel launch counters, by kernel."""
    from vivid_tpu_torch.kernels import flash
    return dict(flash.launches)
