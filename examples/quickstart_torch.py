#!/usr/bin/env python
"""Executable quickstart of the PyTorch port: synthetic scenes -> short
training -> sampling -> metrics, end to end on the first CUDA card (or the
CPU with --device cpu).

    python examples/quickstart_torch.py [--workdir DIR]

Without --workdir it works in a fresh directory under $TMPDIR and prints
its path; a --workdir that exists must be empty, so no run picks up what an
earlier one left there.

The counterpart of examples/quickstart.py, scaled down the same way (a tiny
model, a handful of steps); swap the dataset path for a real scene
directory (or a RealEstate10K root) and drop the size overrides for real
runs. One difference: 32 channels a head where the JAX example has 8. The
attention kernels take head dims 32 and 64, and a CUDA tensor never falls
back to a plain version, so a head of 8 would not run on the card.
"""

import argparse
import glob
import os
import sys
import tempfile

# Allow running straight from a checkout: python examples/quickstart_torch.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_workdir(path=None) -> str:
    """`path`, made if missing and refused unless empty; without one a fresh
    directory under $TMPDIR."""
    if path is None:
        return tempfile.mkdtemp(prefix="vivid_quickstart_torch_")
    if os.path.isdir(path) and os.listdir(path):
        raise SystemExit(f"--workdir {path!r} is not empty: give an empty or new directory")
    os.makedirs(path, exist_ok=True)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None,
                    help="an empty or new directory (default: a fresh one under $TMPDIR)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--resolution", type=int, default=32)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from vivid_tpu_torch.data.scenes import make_synthetic_dataset
    from vivid_tpu_torch.generate import generate_images_nvs
    from vivid_tpu_torch.metrics.api import get_metrics
    from vivid_tpu_torch.train.loop import training_loop

    workdir = make_workdir(args.workdir)
    print("workdir:", workdir)
    data = make_synthetic_dataset(os.path.join(workdir, "scenes"),
                                  num_scenes=8, num_views=8, imsize=args.resolution)
    run_dir = os.path.join(workdir, "run")

    print("=== training ===")
    nimg_per_step = 8 * 6
    training_loop(
        run_dir=run_dir,
        dataset_kwargs={"path": data},
        test_dataset_path=data,
        network_kwargs=dict(img_resolution=args.resolution, model_channels=args.channels,
                            channel_mult=(1, 2), num_blocks=1,
                            attn_resolutions=(args.resolution // 2,), channels_per_head=32),
        loss_kwargs={"P_mean": -0.8, "P_std": 1.6},
        lr_kwargs={"ref_lr": 0.005, "ref_batches": 1000, "rampup_Mimg": 0.001},
        batch_size=8,
        total_nimg=10 ** 9,
        status_nimg=nimg_per_step * 5,
        samples_nimg=None,
        snapshot_nimg=nimg_per_step * args.steps,
        checkpoint_nimg=None,
        max_steps=args.steps,
        debug=True,
        device=args.device,
    )
    snaps = sorted(glob.glob(os.path.join(run_dir, "network-snapshot-*-0.050.pkl")))
    print("snapshot:", snaps[-1])

    print("=== sampling ===")
    outdir = os.path.join(workdir, "samples")
    for _ in generate_images_nvs(net=snaps[-1], outdir=outdir, seeds=range(0, 8),
                                 max_batch_size=8, datakwargs={"path": data}, num_steps=8,
                                 device=args.device):
        pass
    print("samples:", sorted(os.listdir(outdir))[:6], "...")

    print("=== metrics (stub detector) ===")
    results = get_metrics(net=snaps[-1], num_images=8, max_batch_size=8,
                          metrics=["stub_fid", "psnr"], datakwargs={"path": data},
                          num_steps=8, device=args.device)
    print("metrics:", results)
    return dict(workdir=workdir, snapshot=snaps[-1], samples=outdir, metrics=results)


if __name__ == "__main__":
    main()
