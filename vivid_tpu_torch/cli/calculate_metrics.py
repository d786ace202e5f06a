"""Metrics CLI of the PyTorch port: `gen` (generate, then measure) and
`calc` (measure saved images), with the JAX package's flags.

    python -m vivid_tpu_torch.cli.calculate_metrics gen --net=base.pkl \\
        --gnet=uncond.pkl --guidance=1.5 --data=data/ --num=10000 \\
        --metrics=fid,joint_fid,fd_dinov2,joint_fd_dinov2,psnr
    python -m vivid_tpu_torch.cli.calculate_metrics calc --images=out/ \\
        --ref=ref-stats.pkl --metrics=fid,psnr

`calc` reads the src_/tgt_/sample_{seed}.png triplets that `gen --outdir`
and the generation CLI write. Both run on the first CUDA card and fail
without one; `--device cpu` asks for the CPU. Under `torchrun` each
process takes its share of the seeds or images on its card, and the
feature moments are summed over the processes on the group's device. The detectors' weights come
from $VIVID_DETECTOR_DIR (metrics/detectors.py). Each command returns
{metric: value} to a caller that invokes it with standalone_mode=False.
"""

import os
import re
from glob import glob

import click
import numpy as np
import tqdm

from vivid_tpu_torch.core import dist
from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.metrics.detectors import metric_specs
from vivid_tpu_torch.metrics.frechet import calculate_metrics_from_stats_nvs
from vivid_tpu_torch.metrics.stats import calculate_stats_for_iterable_nvs, load_stats
from vivid_tpu_torch.native.fast_image import load_rgb


def parse_metric_list(s):
    metrics = s if isinstance(s, list) else s.split(",")
    for metric in metrics:
        if metric not in metric_specs:
            raise click.ClickException(f'Invalid metric "{metric}"')
    return metrics


def _seed_of(path):
    return int(re.search(r"\d+", os.path.basename(path)).group())


class ImageFolderIterable:
    """src_/tgt_/sample_{seed}.png triplets under `path` (searched
    recursively), in seed order, `max_batch_size` a batch; at most
    `max_size` of them, drawn with `random_seed`."""

    def __init__(self, path, max_size=None, random_seed=0, max_batch_size=64):
        paths = sorted(glob(os.path.join(path, "**", "sample_*.png"), recursive=True),
                       key=_seed_of)
        if max_size is not None and len(paths) > max_size:
            rng = np.random.RandomState(random_seed)
            paths = sorted(rng.choice(paths, max_size, replace=False), key=_seed_of)
        if len(paths) < 2:
            raise click.ClickException(
                f"Found {len(paths)} sample images under {path}, need >= 2")
        self.paths = paths[dist.get_rank()::dist.get_world_size()]
        self.max_batch_size = max_batch_size

    def __len__(self):
        return (len(self.paths) + self.max_batch_size - 1) // self.max_batch_size

    def __iter__(self):
        for i in range(len(self)):
            chunk = self.paths[i * self.max_batch_size:(i + 1) * self.max_batch_size]
            yield EasyDict(
                images=np.stack([load_rgb(p) for p in chunk]),
                tgt=np.stack([load_rgb(p.replace("sample_", "tgt_")) for p in chunk]),
                src=np.stack([load_rgb(p.replace("sample_", "src_")) for p in chunk]),
            )


def _run(image_iter, metrics, ref_path=None, dest_path=None, device=None):
    stats_iter = calculate_stats_for_iterable_nvs(image_iter, metrics=metrics,
                                                  dest_path=dest_path, device=device)
    r = ref = None
    for r, ref in tqdm.tqdm(stats_iter, unit="batch", disable=(dist.get_rank() != 0),
                            leave=False):
        pass
    results = None
    if dist.get_rank() == 0:
        ext_ref = load_stats(ref_path) if ref_path else ref.stats
        results = calculate_metrics_from_stats_nvs(stats=r.stats, ref=ext_ref, metrics=metrics)
    dist.barrier()
    return results


@click.group()
def cmdline():
    """Calculate evaluation metrics (FID, FD-DINOv2, joint variants, PSNR).

    Examples:

    \b
    # Calculate metrics directly for a given model without saving images
    python -m vivid_tpu_torch.cli.calculate_metrics gen --net=snapshot.pkl --data=scenes/ --num=10000

    \b
    # Calculate metrics for saved image triplets
    python -m vivid_tpu_torch.cli.calculate_metrics calc --images=out --ref=ref-stats.pkl
    """


@cmdline.command()
@click.option("--images", "image_path", help="Path to the images", metavar="PATH", type=str, required=True)
@click.option("--ref", "ref_path", help="Dataset reference statistics", metavar="PKL", type=str, default=None)
@click.option("--metrics", help="List of metrics to compute", metavar="LIST", type=parse_metric_list, default="fid,fd_dinov2", show_default=True)
@click.option("--num", "num_images", help="Number of images to use", metavar="INT", type=click.IntRange(min=2), default=50000, show_default=True)
@click.option("--seed", help="Random seed for selecting the images", metavar="INT", type=int, default=0, show_default=True)
@click.option("--batch", "max_batch_size", help="Maximum batch size", metavar="INT", type=click.IntRange(min=1), default=64, show_default=True)
@click.option("--dest", "dest_path", help="Where to save the computed statistics", metavar="PKL", type=str, default=None)
@click.option("--device", help="Device of the detectors  [default: cuda; fails without a card]", metavar="STR", type=str, default=None)
def calc(image_path, ref_path, metrics, num_images, seed, max_batch_size, dest_path, device):
    """Calculate metrics for a given set of saved images."""
    dist.init(device=device)
    image_iter = ImageFolderIterable(image_path, max_size=num_images, random_seed=seed,
                                     max_batch_size=max_batch_size)
    return _run(image_iter, metrics, ref_path=ref_path, dest_path=dest_path, device=device)


@cmdline.command()
@click.option("--net", help="Network snapshot filename", metavar="PATH", type=str, required=True)
@click.option("--data", "data_path", help="Path to scene dataset", metavar="DIR", type=str, required=True)
@click.option("--gnet", help="Guidance network snapshot", metavar="PATH", type=str, default=None, show_default=True)
@click.option("--metrics", help="List of metrics to compute", metavar="LIST", type=parse_metric_list, default="fid,joint_fid,psnr", show_default=True)
@click.option("--num", "num_images", help="Number of images to generate", metavar="INT", type=click.IntRange(min=2), default=10000, show_default=True)
@click.option("--seed", help="Random seed for the generation", metavar="INT", type=int, default=0, show_default=True)
@click.option("--batch", "max_batch_size", help="Maximum batch size", metavar="INT", type=click.IntRange(min=1), default=32, show_default=True)
@click.option("--sr-model", help="Path to SR model snapshot", metavar="STR", type=str, default=None, show_default=True)
@click.option("--range-selection", help="Range selection", metavar="MID,LONG", type=click.Choice(["mid", "long"]), default=None, show_default=True)
@click.option("--guidance", help="Guidance factor", metavar="FLOAT", type=float, default=1.0, show_default=True)
@click.option("--depth-model", help="Depth model for evaluation (small|base|large, weights from $VIVID_DEPTH_DIR)", metavar="STR", type=str, default=None, show_default=True)
@click.option("--outdir", help="Where to save the output images", metavar="DIR", type=str, default=None, show_default=True)
@click.option("--dest", "dest_path", help="Where to save the generated images' statistics", metavar="PKL", type=str, default=None)
@click.option("--vanilla-mode", help="Single-source conditioning", is_flag=True)
@click.option("--device", help="Device to sample and measure on  [default: cuda; fails without a card]", metavar="STR", type=str, default=None)
def gen(net, data_path, metrics, num_images, seed, dest_path, device, **opts):
    """Calculate metrics for a given NVS model using default sampler settings."""
    from vivid_tpu_torch.generate import generate_images_nvs
    dist.init(device=device)
    image_iter = generate_images_nvs(net=net, seeds=range(seed, seed + num_images),
                                     datakwargs={"path": data_path}, device=device, **opts)
    return _run(image_iter, metrics, dest_path=dest_path, device=device)


if __name__ == "__main__":
    cmdline()
