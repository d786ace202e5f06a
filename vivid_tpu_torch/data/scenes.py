"""Multi-view scene dataset: one compressed .npz per scene.

Copy of vivid_tpu/data/scenes.py (numpy only), so both packages read and
write the same scene directories. Keys: `image [V,H,W,3] uint8`,
`c2w [V,4,4]`, `fxfycxcy [V,4]`. Iteration is infinite and shuffled in the
same order as the JAX package's for the same seed; the heavy decode work
runs in the loader thread (data/collate.py).
"""

import os
import random
from glob import glob
from typing import Iterator

import numpy as np

SCENE_KEYS = ("image", "c2w", "fxfycxcy")


def save_scene(path: str, image: np.ndarray, c2w: np.ndarray, fxfycxcy: np.ndarray):
    """image: [V, H, W, 3] uint8 (channel-last); c2w: [V, 4, 4]; fxfycxcy: [V, 4].

    Each view is its own zip member (`image_000`, ...) plus an `image_shape`
    descriptor, so loading decompresses only the views a collate samples.
    load_scene also reads the monolithic `image` layout."""
    if image.ndim != 4 or image.shape[-1] != 3:
        raise ValueError(f"image must be [V, H, W, 3], got {image.shape}")
    image = np.asarray(image, np.uint8)
    views = {f"image_{i:03d}": image[i] for i in range(image.shape[0])}
    np.savez_compressed(path, image_shape=np.asarray(image.shape, np.int64),
                        c2w=np.asarray(c2w, np.float32),
                        fxfycxcy=np.asarray(fxfycxcy, np.float32), **views)


class LazyViews:
    """Array-like [V, H, W, 3] uint8 over a per-view scene .npz, inflating a
    view's member only when indexed (mirrors re10k_scenes.LazyFrames). The
    collates index 2-3 of V views per row; everything else reads `.shape`."""

    def __init__(self, path: str, shape):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self._cache = {}

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, i):
        if isinstance(i, tuple):  # e.g. scene["image"][v, y, x, c]
            view = self[i[0]]
            return view[i[1:]] if len(i) > 1 else view
        if isinstance(i, slice):
            return np.stack([self._view(j) for j in range(*i.indices(len(self)))])
        return self._view(int(i))

    def _view(self, i: int):
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(f"view {i} out of range for {self.shape}")
        if i not in self._cache:
            with np.load(self.path) as z:
                self._cache[i] = z[f"image_{i:03d}"]
        return self._cache[i]

    def __array__(self, dtype=None, copy=None):
        arr = np.stack([self[i] for i in range(len(self))])
        return arr.astype(dtype) if dtype is not None else arr


def load_scene(path: str) -> dict:
    with np.load(path) as z:
        if "image_shape" in z:  # per-view layout: defer pixel inflation
            scene = {k: z[k] for k in SCENE_KEYS if k in z}
            scene["image"] = LazyViews(path, z["image_shape"])
            return scene
        scene = {k: z[k] for k in SCENE_KEYS if k in z}
    img = scene["image"]
    if img.ndim == 4 and img.shape[1] in (1, 3) and img.shape[-1] not in (1, 3):
        scene["image"] = np.moveaxis(img, 1, -1)  # accept NCHW-stored scenes
    return scene


class SceneDataset:
    """Infinite shuffled iteration over scene .npz files (one process).

    path: directory containing *.npz scene files (searched recursively).
    Any other keyword raises ValueError, so a caller's dataset arguments are
    either honoured or refused, never dropped.
    """

    def __init__(self, path: str, seed: int = 0, **unknown):
        if unknown:
            raise ValueError(f"SceneDataset takes path and seed, not {sorted(unknown)}")
        self.path = path
        self.files = sorted(glob(os.path.join(path, "**", "*.npz"), recursive=True))
        if not self.files:
            raise IOError(f"No scene .npz files found under {path!r}")
        self.seed = seed

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[dict]:
        order = list(range(len(self.files)))
        rnd = random.Random(self.seed)
        while True:
            rnd.shuffle(order)
            for idx in order:
                try:
                    yield load_scene(self.files[idx])
                except Exception:
                    continue  # skip corrupt scenes, like the reference collate


def synthesize_scene(rng: np.random.RandomState, num_views: int = 8,
                     imsize: int = 64) -> dict:
    """Procedural scene for tests/benchmarks: textured gradient views of a
    smooth camera track with plausible RealEstate10K-scale intrinsics.

    The base texture is LOW-FREQUENCY (random coarse grid bilinearly
    upsampled + a faint mid-frequency layer), not white noise: views must be
    compressible for overfit/convergence smokes to be able to reconstruct
    them from conditioning (a U-Net cannot memorize per-pixel white noise
    through a 20-d geometry key), and smooth textures make adjacent views
    correlated the way real scenes are."""
    views, c2ws, ks = [], [], []

    def _smooth(cells, size):
        g = rng.rand(cells, cells, 3)
        yi = np.linspace(0, cells - 1, size)
        xi = np.linspace(0, cells - 1, size)
        y0 = np.clip(yi.astype(int), 0, cells - 2)
        x0 = np.clip(xi.astype(int), 0, cells - 2)
        fy = (yi - y0)[:, None, None]
        fx = (xi - x0)[None, :, None]
        a = g[y0][:, x0]
        b = g[y0][:, x0 + 1]
        c = g[y0 + 1][:, x0]
        d = g[y0 + 1][:, x0 + 1]
        return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
                + c * fy * (1 - fx) + d * fy * fx)

    size = imsize * 2
    base = (0.85 * _smooth(6, size) + 0.15 * _smooth(24, size)) * 255
    for v in range(num_views):
        ox, oy = v % (imsize // 2), (v * 3) % (imsize // 2)
        img = base[oy:oy + imsize, ox:ox + imsize]
        views.append(img.astype(np.uint8))
        angle = 0.02 * v
        c, s = np.cos(angle), np.sin(angle)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        c2w[:3, 3] = np.array([0.1 * v, 0.01 * v, 0.05 * v], np.float32)
        c2ws.append(c2w)
        ks.append(np.array([57.7 + rng.randn(), 57.7 + rng.randn(), 32.0, 32.0],
                           np.float32))
    return dict(image=np.stack(views), c2w=np.stack(c2ws), fxfycxcy=np.stack(ks))


def make_synthetic_dataset(path: str, num_scenes: int = 8, num_views: int = 8,
                           imsize: int = 64, seed: int = 0):
    """Materialize a tiny synthetic dataset on disk (tests / smoke runs)."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(num_scenes):
        scene = synthesize_scene(rng, num_views=num_views, imsize=imsize)
        save_scene(os.path.join(path, f"scene_{i:05d}.npz"), **scene)
    return path
