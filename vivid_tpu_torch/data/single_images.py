"""Single-image co-training: view pairs synthesised from single images.

Counterpart of vivid_tpu/data/single_images.py, in numpy. A fake row
applies random camera rotations (pure homographies, no translation) to one
image: one view per source and one for the target. The random draws are
the JAX package's for the same seed: the file and the angle regime from
Python's `random`, the angles from JAX's threefry stream (reimplemented
here: `prng_key`, `fold_in`, `split`, `uniform`), so both packages rotate
the same image by the same angles. The warp (geometry/warp.py
`euler_to_rotation_matrix`, `warp_perspective`) runs in float32 in the JAX
package's order of operations, so the rows match its bits; where numpy's
float32 sine or cosine rounds otherwise than XLA's, or the fused sums of
the projection round twice here, a view can differ by one level.

`sample_plan` makes a row's draws without touching pixels and `materialize`
builds the row, so `BatchLoader(skip_rows=)` fast-forwards this stream as
it does the scene collates.
"""

import os
import random
from glob import glob
from typing import Optional

import numpy as np
import PIL.Image
import torch

from vivid_tpu_torch.data.collate import resize_image
from vivid_tpu_torch.geometry.codec import compose_geometry_np
from vivid_tpu_torch.geometry.warp import euler_to_rotation_matrix, inverse_3x3, warp_perspective

# -- JAX's threefry-2x32 stream, in numpy ----------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters (x1, x2) under key
    (k1, k2), elementwise on uint32 arrays."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed): the seed's 64 bits as two uint32 words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in: the key hashed with the counters (0, data)."""
    a, b = _threefry2x32(key[0], key[1], np.uint32(0), np.uint32(data))
    return np.array([a, b], np.uint32)


def split(key, num: int):
    """jax.random.split into `num` keys (the partitionable scheme)."""
    a, b = _threefry2x32(key[0], key[1], np.zeros(num, np.uint32),
                         np.arange(num, dtype=np.uint32))
    return [np.array([x, y], np.uint32) for x, y in zip(a, b)]


def uniform(key, minval=-1.0, maxval=1.0) -> np.float32:
    """One float32 of jax.random.uniform: 23 random mantissa bits."""
    a, b = _threefry2x32(key[0], key[1], np.uint32(0), np.uint32(0))
    bits = (a ^ b) >> np.uint32(9) | np.float32(1.0).view(np.uint32)
    u = bits.view(np.float32) - np.float32(1.0)
    return max(np.float32(minval), u * np.float32(maxval - minval) + np.float32(minval))


# -- the rotation and its homography warp ----------------------------------------

def random_camera_rotation(key, image, intrinsics, max_angle_pitch=0.0, max_angle_yaw=10.0,
                           max_angle_roll=0.0):
    """A rotated view of `image` [H, W, C] float32 through the homography
    K R K^-1 -> (view, R): the angles uniform in +-max degrees."""
    deg = np.float32(np.pi / 180.0)
    kp, ky, kr = split(key, 3)
    pitch = uniform(kp) * np.float32(max_angle_pitch) * deg
    yaw = uniform(ky) * np.float32(max_angle_yaw) * deg
    roll = uniform(kr) * np.float32(max_angle_roll) * deg
    R = euler_to_rotation_matrix(pitch, yaw, roll).numpy()
    H = intrinsics @ R @ inverse_3x3(torch.from_numpy(intrinsics)).numpy()
    return warp_perspective(torch.from_numpy(image), torch.from_numpy(H)).numpy(), R


def _expand(pose):
    return np.concatenate([pose, np.array([[0, 0, 0, 1]], pose.dtype)], 0)


class SingleImages:
    """Iterable over the *.png / *.jpg files under `path`, giving rows of
    the scene collates' schema (src_image [S, h, w, 3], tgt_image, geometry
    [S, 20]; with `sr_size` the sr_* fields too)."""

    def __init__(self, path: str, imsize: int = 64, sr_size: Optional[int] = None,
                 num_sources: int = 2, seed: int = 0):
        self.paths = sorted(glob(os.path.join(path, "**", "*.png"), recursive=True)
                            + glob(os.path.join(path, "**", "*.jpg"), recursive=True))
        if not self.paths:
            raise IOError(f"No images under {path!r}")
        self.imsize = imsize
        self.sr_size = sr_size
        self.num_sources = num_sources
        self.rng = random.Random(seed)
        self.key = prng_key(seed)
        self._key_idx = 0

    def __len__(self):
        return len(self.paths)

    def sample_plan(self, scene=None) -> list:
        """A row's draws, without touching pixels: [(path, angles, key0)]."""
        path = self.rng.choice(self.paths)
        angles = (8.3, 8.3, 3.5) if self.rng.random() < 0.5 else (5.5, 5.5, 0.0)
        key0 = self._key_idx
        self._key_idx += self.num_sources + 1
        return [(path, angles, key0)]

    def materialize(self, scene, plan: list) -> list:
        return [self._planned_row(*p) for p in plan]

    def rows_from_scene(self, scene=None) -> list:
        """Collate protocol: ignores `scene`, gives one synthetic row."""
        return self.materialize(scene, self.sample_plan())

    def _planned_row(self, path, angles, key0) -> dict:
        img = np.asarray(PIL.Image.open(path).convert("RGB")).astype(np.float32)
        h, w = img.shape[:2]
        f = 0.6
        K = np.array([[w * f, 0, w * 0.5], [0, h * f, h * 0.5], [0, 0, 1.0]], np.float32)
        views, rots = [], []
        for i in range(self.num_sources + 1):   # the sources, then the target
            v, R = random_camera_rotation(fold_in(self.key, key0 + 1 + i), img, K, *angles)
            views.append(v)
            rots.append(np.concatenate([R, np.zeros((3, 1), np.float32)], 1))
        crop = min(h, w)
        top, left = (h - crop) // 2, (w - crop) // 2

        def prep(v, size):
            return resize_image(np.clip(v[top:top + crop, left:left + crop], 0, 255)
                                .astype(np.uint8), size)

        def K_for(size):
            Kc = K.copy()
            Kc[:2, 2] -= np.array([left, top])
            Kc[:2] *= size / crop
            return np.array([Kc[0, 0], Kc[1, 1], Kc[0, 2], Kc[1, 2]], np.float32)

        def geo(src_ext, size):
            rel = (_expand(src_ext) @ np.linalg.inv(_expand(rots[-1])))[:3]
            return compose_geometry_np(rel, K_for(size), K_for(size), imsize=size)

        row = {}
        for prefix, size in (("", self.imsize), ("sr_", self.sr_size)):
            if size is None:
                continue
            row[prefix + "src_image"] = np.stack([prep(v, size) for v in views[:-1]])
            row[prefix + "tgt_image"] = prep(views[-1], size)
            row[prefix + "geometry"] = np.stack([geo(e, size) for e in rots[:-1]]
                                                ).astype(np.float32)
        return row

    def __iter__(self):
        while True:
            yield None  # rows are synthesised; the iterator only drives the loader
