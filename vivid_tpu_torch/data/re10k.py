"""RealEstate10K as the reference lays it out on disk.

Copy of vivid_tpu/data/re10k.py (numpy and PIL only). Each sequence is a
camera file `RealEstate10K/<split>/<seq>.txt` (a URL line, then one line per
frame: timestamp, intrinsics normalised by the 640 x 360 frame, two unused
fields, a 3 x 4 world-to-camera pose) beside a directory of frames
`<split>/<seq>/<timestamp>.png`. `RealEstate10K` is the reference's item
dataset: two frames of a sequence per item, drawn at random or a
`range_selection` apart ('mid': 30-60 frames, 'long': 60-120), centre-cropped
and resized to `imsize` and `imsize * sr_mult`, with the geometry vector of
each size. Its configuration name is `datautils.RealEstate10K` or
`vivid_tpu.data.re10k.RealEstate10K` (core/registry.py). The scene stream
the collates read is data/re10k_scenes.py.
"""

import os
import random
from glob import glob
from typing import Optional

import numpy as np
import PIL.Image

from vivid_tpu_torch.geometry.codec import compose_geometry_np
from vivid_tpu_torch.native.fast_image import load_rgb

RANGE_SELECTIONS = {"mid": (30, 60), "long": (60, 120)}


def parse_line(line: str, width: int = 640, height: int = 360):
    """One camera line -> (timestamp, K [3, 3], world-to-camera pose [3, 4])."""
    items = line.split(" ")
    timestamp = items[0]
    fx, fy, cx, cy = map(float, items[1:5])
    K = np.array([[width * fx, 0, width * cx],
                  [0, height * fy, height * cy],
                  [0, 0, 1]], np.float64)
    pose = np.array(list(map(float, items[7:])), np.float64).reshape(3, 4)
    return timestamp, K, pose


def transform_coordinates(K, new_size, center_crop_size, old_width=640, old_height=360):
    """K after a centre crop to `center_crop_size` and a resize to `new_size`."""
    K = K.copy()
    corner = np.array([(old_width - center_crop_size) // 2,
                       (old_height - center_crop_size) // 2], np.float64)
    K[:2, 2] -= corner
    K[:2] = new_size * K[:2] / center_crop_size
    return K


def expand_extrinsics_np(pose):
    return np.concatenate([pose, np.array([[0, 0, 0, 1]], pose.dtype)], 0)


def _center_crop_resize(img: np.ndarray, crop: int, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top, left = (h - crop) // 2, (w - crop) // 2
    img = img[top:top + crop, left:left + crop]
    pil = PIL.Image.fromarray(img.astype(np.uint8), "RGB")
    return np.asarray(pil.resize((size, size), PIL.Image.Resampling.BILINEAR),
                      dtype=np.float32)


def nvs_transforms(src_image, src_K, src_pose, tgt_image, tgt_K, tgt_pose,
                   imsize, srsize):
    """The {src_image, tgt_image, geometry, sr_*} record of one frame pair.
    Poses are world-to-camera, as in the files; the relative extrinsics are
    src_w2c @ inv(tgt_w2c)."""
    old_h, old_w = src_image.shape[:2]
    crop = min(old_h, old_w)
    out = {}
    for size, prefix in ((imsize, ""), (srsize, "sr_")):
        sK = transform_coordinates(src_K, size, crop, old_w, old_h)
        tK = transform_coordinates(tgt_K, size, crop, old_w, old_h)
        rel = (expand_extrinsics_np(src_pose) @
               np.linalg.inv(expand_extrinsics_np(tgt_pose)))[:3]
        geo = compose_geometry_np(
            rel, np.array([sK[0, 0], sK[1, 1], sK[0, 2], sK[1, 2]], np.float32),
            np.array([tK[0, 0], tK[1, 1], tK[0, 2], tK[1, 2]], np.float32),
            imsize=size)
        out[prefix + "src_image"] = _center_crop_resize(src_image, crop, size)
        out[prefix + "tgt_image"] = _center_crop_resize(tgt_image, crop, size)
        out[prefix + "geometry"] = geo.astype(np.float32)
    return out


def read_lines(seq_path: str):
    """A camera file's frame lines (its first line, the URL, dropped)."""
    with open(seq_path) as f:
        return f.read().splitlines()[1:]


class RealEstate10K:
    def __init__(self, split="train", imsize=64, data_root="data", sr_mult=4,
                 range_selection: Optional[str] = None, seed: int = 0):
        self.split = split
        self.imsize = imsize
        self.srsize = imsize * sr_mult
        self.num_channels = 3
        self.data_root = data_root
        self.range_selection = range_selection
        self.rng = random.Random(seed)
        sequence_dir = os.path.join(data_root, "RealEstate10K", split)
        self.sequence_paths = [
            p for p in sorted(glob(os.path.join(sequence_dir, "*.txt")))
            if os.path.isdir(os.path.join(data_root, split,
                                          os.path.basename(p)[:-len(".txt")]))]
        if range_selection is not None:
            s, _ = RANGE_SELECTIONS[range_selection]
            self.sequence_paths = [p for p in self.sequence_paths
                                   if len(read_lines(p)) > s]
        if not self.sequence_paths:
            raise IOError(f"No RealEstate10K sequences under {data_root!r} ({split})")

    def __len__(self):
        return len(self.sequence_paths)

    def _sample_indices(self, n: int):
        if self.range_selection is None:
            if n == 1:
                return 0, 0
            return tuple(self.rng.sample(range(n), 2))
        s, e = RANGE_SELECTIONS[self.range_selection]
        i1 = self.rng.randrange(n)
        candidates = [j for j in range(n) if s <= abs(j - i1) < e]
        if not candidates:
            return tuple(self.rng.sample(range(n), 2))
        return i1, self.rng.choice(candidates)

    def __getitem__(self, index: int) -> dict:
        seq_path = self.sequence_paths[index]
        seq = os.path.basename(seq_path)[:-len(".txt")]
        lines = read_lines(seq_path)
        i1, i2 = self._sample_indices(len(lines))
        src_ts, src_K, src_pose = parse_line(lines[i1])
        tgt_ts, tgt_K, tgt_pose = parse_line(lines[i2])
        frame_dir = os.path.join(self.data_root, self.split, seq)
        src_image = load_rgb(os.path.join(frame_dir, src_ts + ".png"))
        tgt_image = load_rgb(os.path.join(frame_dir, tgt_ts + ".png"))
        return nvs_transforms(src_image, src_K, src_pose, tgt_image, tgt_K,
                              tgt_pose, self.imsize, self.srsize)

    def __iter__(self):
        while True:
            yield self[self.rng.randrange(len(self))]
