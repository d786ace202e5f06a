"""Dump random scenes of a dataset to PNG strips for eyeballing.

Counterpart of the repository's root `inspect_dataset.py`, on the port's
dataset factory, so it reads a RealEstate10K txt + png tree as well as a
directory of scene .npz files:

    python -m vivid_tpu_torch.cli.inspect_dataset --data=scenes/ --outdir=inspect/
"""

import os

import click
import numpy as np
import PIL.Image


@click.command()
@click.option("--data", required=True, help="Scene dataset directory or RealEstate10K root")
@click.option("--outdir", default="dataset_inspection", show_default=True)
@click.option("--num-scenes", default=30, show_default=True)
@click.option("--views-per-scene", default=3, show_default=True)
@click.option("--seed", default=0, show_default=True)
def main(data, outdir, num_scenes, views_per_scene, seed):
    from vivid_tpu_torch.data.re10k_scenes import open_scene_dataset
    os.makedirs(outdir, exist_ok=True)
    ds = open_scene_dataset(data, seed=seed)
    rng = np.random.RandomState(seed)
    it = iter(ds)
    count = min(num_scenes, len(ds))
    for i in range(count):
        scene = next(it)
        imgs = scene["image"]
        idx = rng.choice(imgs.shape[0], min(views_per_scene, imgs.shape[0]), replace=False)
        strip = np.concatenate([imgs[j] for j in idx], axis=1)
        path = os.path.join(outdir, f"scene_{i:03d}.png")
        PIL.Image.fromarray(strip.astype(np.uint8), "RGB").save(path)
        print(f"{path}: views={imgs.shape[0]} size={imgs.shape[1]}x{imgs.shape[2]} "
              f"c2w_range=[{scene['c2w'][:, :3, 3].min():.3f},"
              f"{scene['c2w'][:, :3, 3].max():.3f}]")
    print(f"Wrote {count} scene strips to {outdir}")
    return count


if __name__ == "__main__":
    main()
