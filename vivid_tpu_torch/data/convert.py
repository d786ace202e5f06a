"""Dataset converters into the .npz scene format.

Copy of vivid_tpu/data/convert.py. Sources:
  * RealEstate10K txt + png trees (data/re10k.py's layout): frames
    centre-cropped to squares, world-to-camera poses inverted to c2w,
    intrinsics in the geometry codec's 64-px convention;
  * generic directories of frames, one a scene, each with a poses.json;
  * LitData chunk directories (the reference's streaming format), where the
    `litdata` package is installed.

    python -m vivid_tpu_torch.data.convert re10k --src data/ --split train --dst scenes/
    python -m vivid_tpu_torch.data.convert imagedirs --src dirs/ --dst scenes/
    python -m vivid_tpu_torch.data.convert litdata --src chunks/ --dst scenes/
"""

import json
import os
from glob import glob

import click
import numpy as np

from vivid_tpu_torch.data.re10k import parse_line, read_lines
from vivid_tpu_torch.data.scenes import save_scene
from vivid_tpu_torch.native.fast_image import load_rgb


def _to_uint8_hwc(image) -> np.ndarray:
    arr = np.asarray(image)
    if arr.ndim == 4 and arr.shape[1] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = np.moveaxis(arr, 1, -1)  # VCHW -> VHWC
    if arr.dtype != np.uint8:
        scale = 255.0 if arr.max() <= 2.0 else 1.0
        arr = np.clip(arr * scale, 0, 255).astype(np.uint8)
    return arr


@click.group()
def cmdline():
    """Convert datasets into the .npz scene format."""


@cmdline.command()
@click.option("--src", required=True, help="LitData chunk directory")
@click.option("--dst", required=True, help="Output scene directory")
@click.option("--max-scenes", type=int, default=None)
def litdata(src, dst, max_scenes):
    """Convert a LitData StreamingDataset (keys image/c2w/fxfycxcy)."""
    try:
        import litdata as ld
    except ImportError as err:
        raise click.ClickException(
            "litdata is not installed in this environment; run this converter "
            f"where the reference's pipeline dependencies exist ({err}).")
    os.makedirs(dst, exist_ok=True)
    ds = ld.StreamingDataset(input_dir=src, shuffle=False)
    for i, scene in enumerate(ds):
        if max_scenes is not None and i >= max_scenes:
            break
        save_scene(os.path.join(dst, f"scene_{i:06d}.npz"),
                   image=_to_uint8_hwc(scene["image"]),
                   c2w=np.asarray(scene["c2w"], np.float32),
                   fxfycxcy=np.asarray(scene["fxfycxcy"], np.float32))
        if i % 100 == 0:
            click.echo(f"converted {i} scenes")
    click.echo("done")


@cmdline.command()
@click.option("--src", "data_root", required=True, help="RealEstate10K data root")
@click.option("--split", default="train", show_default=True)
@click.option("--dst", required=True)
@click.option("--max-scenes", type=int, default=None)
def re10k(data_root, split, dst, max_scenes):
    """Convert RealEstate10K txt+png sequences (w2c poses -> c2w)."""
    os.makedirs(dst, exist_ok=True)
    count = 0
    for seq_path in sorted(glob(os.path.join(data_root, "RealEstate10K", split, "*.txt"))):
        if max_scenes is not None and count >= max_scenes:
            break
        seq = os.path.basename(seq_path)[:-len(".txt")]
        frame_dir = os.path.join(data_root, split, seq)
        if not os.path.isdir(frame_dir):
            continue
        images, c2ws, ks = [], [], []
        for line in read_lines(seq_path):
            ts, K, w2c = parse_line(line)
            frame = os.path.join(frame_dir, ts + ".png")
            if not os.path.exists(frame):
                continue
            img = load_rgb(frame)
            h, w = img.shape[:2]
            crop = min(h, w)
            top, left = (h - crop) // 2, (w - crop) // 2
            Kc = K.copy()
            Kc[:2, 2] -= np.array([left, top])
            c2w = np.linalg.inv(np.concatenate([w2c, np.array([[0, 0, 0, 1.0]])], 0))
            images.append(img[top:top + crop, left:left + crop])
            c2ws.append(c2w.astype(np.float32))
            ks.append(np.array([Kc[0, 0], Kc[1, 1], Kc[0, 2], Kc[1, 2]],
                               np.float32) * 64.0 / crop)
        if len(images) < 2:
            continue
        save_scene(os.path.join(dst, seq + ".npz"), image=np.stack(images),
                   c2w=np.stack(c2ws), fxfycxcy=np.stack(ks))
        count += 1
        if count % 50 == 0:
            click.echo(f"converted {count} scenes")
    click.echo(f"done ({count} scenes)")


@cmdline.command()
@click.option("--src", required=True,
              help="Directory of scene dirs, each with frames + poses.json "
                   "({'c2w': [V,4,4], 'fxfycxcy': [V,4]})")
@click.option("--dst", required=True)
def imagedirs(src, dst):
    """Convert generic per-scene image directories."""
    os.makedirs(dst, exist_ok=True)
    count = 0
    for scene_dir in sorted(glob(os.path.join(src, "*"))):
        poses_path = os.path.join(scene_dir, "poses.json")
        if not os.path.isdir(scene_dir) or not os.path.exists(poses_path):
            continue
        with open(poses_path) as f:
            poses = json.load(f)
        frames = sorted(glob(os.path.join(scene_dir, "*.png"))
                        + glob(os.path.join(scene_dir, "*.jpg")))
        images = np.stack([load_rgb(p) for p in frames])
        save_scene(os.path.join(dst, os.path.basename(scene_dir) + ".npz"),
                   image=images, c2w=np.asarray(poses["c2w"], np.float32),
                   fxfycxcy=np.asarray(poses["fxfycxcy"], np.float32))
        count += 1
    click.echo(f"done ({count} scenes)")


if __name__ == "__main__":
    cmdline()
