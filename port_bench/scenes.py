"""The scene tree a sampling cell reads, written at set-up from the seed.

One uncompressed .npz per scene in the per-view layout that the program's
scene reader takes (`image_shape`, `image_000`, ..., `c2w`, `fxfycxcy`):
uint8 views of uniform noise, camera-to-world matrices of a small random
rotation and translation, and intrinsics near 0.9 x the image size with the
principal point at the centre. Every view's pixels are distinct, so a row of
a batch names its scene and views by its pixels (`SceneIndex.find`).
"""

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np


def _rotation(rng, max_angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(-max_angle, max_angle)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


@dataclass
class SceneIndex:
    images: np.ndarray                  # [scenes, views, H, W, 3] uint8
    c2w: np.ndarray                     # [scenes, views, 4, 4]
    fxfycxcy: np.ndarray                # [scenes, views, 4]
    by_hash: Dict[bytes, Tuple[int, int]] = field(default_factory=dict)

    def find(self, pixels: np.ndarray) -> Tuple[int, int]:
        """(scene, view) whose image is `pixels` ([H, W, 3] uint8); KeyError
        when no view of the tree has them."""
        return self.by_hash[hashlib.sha1(np.ascontiguousarray(pixels).tobytes()).digest()]


def write_scenes(path: str, seed: int, count: int, views: int, imsize: int) -> SceneIndex:
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng([seed, 0x5CE7E])
    images = rng.integers(0, 256, (count, views, imsize, imsize, 3), dtype=np.uint8)
    c2w = np.tile(np.eye(4, dtype=np.float32), (count, views, 1, 1))
    k = np.empty((count, views, 4), np.float32)
    for s in range(count):
        for v in range(views):
            c2w[s, v, :3, :3] = _rotation(rng, 0.2)
            c2w[s, v, :3, 3] = rng.normal(scale=0.3, size=3)
            k[s, v] = (0.9 * imsize * (1 + 0.05 * rng.normal()),
                       0.9 * imsize * (1 + 0.05 * rng.normal()), imsize / 2, imsize / 2)
        members = {f"image_{v:03d}": images[s, v] for v in range(views)}
        np.savez(os.path.join(path, f"scene_{s:05d}.npz"),
                 image_shape=np.asarray(images[s].shape, np.int64), c2w=c2w[s],
                 fxfycxcy=k[s], **members)
    index = SceneIndex(images, c2w, k)
    for s in range(count):
        for v in range(views):
            index.by_hash[hashlib.sha1(images[s, v].tobytes()).digest()] = (s, v)
    if len(index.by_hash) != count * views:
        raise RuntimeError("two views of the scene tree have the same pixels")
    return index
