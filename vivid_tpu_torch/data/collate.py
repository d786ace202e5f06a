"""Dual-source view collation into fixed-shape batches, and the threaded
batch loader.

Copy of the parts of vivid_tpu/data/collate.py that sampling and training
use (numpy + PIL only): per scene, three random views become two sources and one shared
target: src [B, 2, h, w, 3], tgt [B, h, w, 3], geometry [B, 2, 20]. The
random draws are the same as the JAX package's for the same seed, so both
packages see the same batches. Images come out as float32 in [0, 255].
"""

import queue
import random as _random
import threading
from typing import Iterator

import numpy as np
import PIL.Image

from vivid_tpu_torch.geometry.codec import compose_geometry_np


def resize_image(img: np.ndarray, size: int) -> np.ndarray:
    """[H, W, 3] any-range float/uint8 -> [size, size, 3] float32, [0,255].
    Integer downscales are a box filter (exact mean); other sizes go through
    PIL bilinear."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        scale = 255.0 if arr.max() < 2.0 else 1.0
        arr = np.clip(arr * scale, 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    if h == w and h != size and h % size == 0:
        f = h // size
        return arr.reshape(size, f, size, f, 3).mean(axis=(1, 3), dtype=np.float32)
    if h != size or w != size:
        pil = PIL.Image.fromarray(arr, "RGB")
        arr = np.asarray(pil.resize((size, size), PIL.Image.Resampling.BILINEAR))
    return arr.astype(np.float32)


def _pair_geometry(scene, src_idx, tgt_idx, imsize):
    src_c2w = np.asarray(scene["c2w"][src_idx], np.float64)
    tgt_c2w = np.asarray(scene["c2w"][tgt_idx], np.float64)
    tgt2src = (np.linalg.inv(tgt_c2w) @ src_c2w)[:3, :]
    return compose_geometry_np(tgt2src, scene["fxfycxcy"][src_idx],
                               scene["fxfycxcy"][tgt_idx], imsize=imsize)


class DualSourceCollate:
    """Two sources sharing one target per scene. `sample_plan` makes every
    random draw for a scene without touching pixels and `materialize` builds
    the planned rows, so a loader can replay the draws of rows already
    consumed at the cost of the draws alone."""

    nimg_mult = 6  # the reference counts +batch*6 images per step in dual mode

    def __init__(self, imsize: int = 64, seed: int = 0):
        self.imsize = imsize
        self.rng = _random.Random(seed)

    def _row(self, scene, s1, s2, t):
        return {
            "src_image": np.stack([resize_image(scene["image"][s1], self.imsize),
                                   resize_image(scene["image"][s2], self.imsize)]),
            "tgt_image": resize_image(scene["image"][t], self.imsize),
            "geometry": np.stack([_pair_geometry(scene, s1, t, self.imsize),
                                  _pair_geometry(scene, s2, t, self.imsize)]
                                 ).astype(np.float32),
        }

    def sample_plan(self, scene) -> list:
        """(s1, s2, t) view-index tuples for this scene."""
        n = scene["image"].shape[0]
        if n < 3:
            return []
        return [tuple(self.rng.sample(range(n), 3))]

    def materialize(self, scene, plan: list) -> list:
        return [self._row(scene, *p) for p in plan]

    def rows_from_scene(self, scene) -> list:
        return self.materialize(scene, self.sample_plan(scene))


class BatchLoader:
    """Background-thread batch assembler: draws scenes from an (infinite)
    iterator, collates rows, stacks exactly `batch_size` of them, and
    prefetches batches so host IO overlaps device compute. One assembly
    thread, so batch contents follow the collate's seed exactly (the JAX
    package's loader runs several). A finite iterator's tail batch is padded
    by repeating its last row; `valid` marks the real rows. `skip_rows`
    replays the draws of that many rows (no pixel work) before the first
    batch: a resumed run continues the stream where the earlier one stopped."""

    def __init__(self, scene_iter: Iterator, collate, batch_size: int,
                 prefetch: int = 2, skip_rows: int = 0):
        self.scene_iter = scene_iter
        self.collate = collate
        self.batch_size = batch_size
        self.queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._initial_rows = []
        skipped = 0
        while skipped < skip_rows:
            scene = next(self.scene_iter)
            plan = self.collate.sample_plan(scene)
            if skipped + len(plan) > skip_rows:   # the boundary falls inside a scene
                self._initial_rows = self.collate.materialize(scene, plan[skip_rows - skipped:])
            skipped = min(skipped + len(plan), skip_rows)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _next_rows(self):
        try:
            scene = next(self.scene_iter)
        except StopIteration:
            return None
        try:
            return self.collate.rows_from_scene(scene)
        except Exception:
            return []  # skip a scene that fails to decode, as the reference does

    def _worker(self):
        pending, self._initial_rows = self._initial_rows, []
        while not self._stop.is_set():
            rows = self._next_rows()
            n_valid = None
            if rows is None:
                if not pending:
                    self.queue.put(None)
                    return
                n_valid = len(pending)
                while len(pending) < self.batch_size:
                    pending.append(pending[-1])
            else:
                pending.extend(rows)
            while len(pending) >= self.batch_size:
                batch_rows = pending[:self.batch_size]
                pending = pending[self.batch_size:]
                batch = {k: np.stack([r[k] for r in batch_rows]) for k in batch_rows[0]}
                mask = np.ones(self.batch_size, bool)
                if n_valid is not None:
                    mask[n_valid:] = False
                batch["valid"] = mask
                self.queue.put(batch)  # daemon threads; close() drains to unblock

    def __iter__(self):
        return self

    def __next__(self):
        item = self.queue.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
