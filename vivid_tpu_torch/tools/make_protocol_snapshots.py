"""Snapshots at the shipped widths from seeds, for the serving protocol's
wall-clock runs, and a 256px synthetic scene tree to condition them.

    python -m vivid_tpu_torch.tools.make_protocol_snapshots [--outdir DIR] [--scenes 32]

The counterpart of tools/make_protocol_snapshots.py: `base.pkl` (vivid-base:
ch 128, two sources, labels 20/40), `gnet.pkl` (vivid-uncond, its guide) and
`sr.pkl` (the 57.5M single-source 256px SR model of the reference's
experiments log, extra_attn 1), random weights from seeds 0, 1 and 2, and
`scenes256/`. The weights are random: what a protocol run measures is the
computation, whose shape is the shipped models'. Existing files are kept.
"""

import argparse
import dataclasses
import os
import sys


def protocol_configs(channels: int = 128, sr_channels: int = 64) -> dict:
    """{name: (PrecondConfig, seed)}: the JAX tool's three models; smaller
    `channels` / `sr_channels` give the same models narrower."""
    from vivid_tpu_torch.nn.precond import PrecondConfig
    base = PrecondConfig(img_resolution=64, num_sources=2, model_channels=channels,
                         extra_attn=1, use_bf16=True, remat=False, source_label_dim=20,
                         target_label_dim=40)
    return {"base": (base, 0),
            "gnet": (dataclasses.replace(base, uncond=True), 1),
            "sr": (PrecondConfig(img_resolution=256, num_sources=1, model_channels=sr_channels,
                                 super_res=True, extra_attn=1, source_label_dim=20,
                                 target_label_dim=20, use_bf16=True, remat=False), 2)}


def write_snapshots(outdir: str, configs: dict, device="cpu") -> dict:
    """Write `<outdir>/<name>.pkl` for each config -> {name: path}."""
    from vivid_tpu_torch.nn.precond import NVPrecond
    from vivid_tpu_torch.train.snapshots import save_snapshot
    os.makedirs(outdir, exist_ok=True)
    paths = {}
    for name, (cfg, seed) in configs.items():
        paths[name] = path = os.path.join(outdir, f"{name}.pkl")
        if os.path.exists(path):
            print("exists:", path)
            continue
        net = NVPrecond(cfg, device=device, seed=seed)
        save_snapshot(path, net)
        print(f"wrote {path}: {sum(p.numel() for p in net.parameters()) / 1e6:.2f}M params")
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default="protocol_snapshots")
    ap.add_argument("--scenes", type=int, default=32)
    args = ap.parse_args(argv)
    from vivid_tpu_torch.data.scenes import make_synthetic_dataset
    data = os.path.join(args.outdir, "scenes256")
    if not os.path.isdir(data):
        make_synthetic_dataset(data, num_scenes=args.scenes, num_views=8, imsize=256)
    print("scenes:", data)
    write_snapshots(args.outdir, protocol_configs())
    return 0


if __name__ == "__main__":
    sys.exit(main())
