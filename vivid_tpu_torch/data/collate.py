"""View collation into fixed-shape batches, and the threaded batch loader.

Copy of the parts of vivid_tpu/data/collate.py that sampling and training
use (numpy + PIL only). Dual-source: per scene, three random views become
two sources and one shared target: src [B, 2, h, w, 3], tgt [B, h, w, 3],
geometry [B, 2, 20]. Vanilla: two random views, one source and one target:
src [B, 1, h, w, 3], geometry [B, 1, 20]. With `sr_size`, each row also
carries the same views at that size (sr_src_image, sr_tgt_image,
sr_geometry) for the super-resolution stage. The random draws are the same
as the JAX package's for the same seed, so both packages see the same
batches. Images come out as float32 in [0, 255].
"""

import queue
import random as _random
import threading
from typing import Iterator, Optional

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


class _Collate:
    """`sample_plan` makes every random draw for a scene without touching
    pixels and `materialize` builds the planned rows, so a loader can replay
    the draws of rows already consumed at the cost of the draws alone. A
    plan entry is (source views..., target view)."""

    num_views = 0   # views drawn per scene: the sources, then the target

    def __init__(self, imsize: int = 64, sr_size: Optional[int] = None, seed: int = 0):
        self.imsize = imsize
        self.sr_size = sr_size
        self.rng = _random.Random(seed)

    def _views(self, scene, sources, t, size):
        return (np.stack([resize_image(scene["image"][s], size) for s in sources]),
                resize_image(scene["image"][t], size),
                np.stack([_pair_geometry(scene, s, t, size) for s in sources]
                         ).astype(np.float32))

    def _row(self, scene, *views):
        *sources, t = views
        row = dict(zip(("src_image", "tgt_image", "geometry"),
                       self._views(scene, sources, t, self.imsize)))
        if self.sr_size is not None:
            row.update(zip(("sr_src_image", "sr_tgt_image", "sr_geometry"),
                           self._views(scene, sources, t, self.sr_size)))
        return row

    def sample_plan(self, scene) -> list:
        """View-index tuples for this scene."""
        n = scene["image"].shape[0]
        if n < self.num_views:
            return []
        return [tuple(self.rng.sample(range(n), self.num_views))]

    def materialize(self, scene, plan: list) -> list:
        return [self._row(scene, *p) for p in plan]

    def rows_from_scene(self, scene) -> list:
        return self.materialize(scene, self.sample_plan(scene))


class VanillaCollate(_Collate):
    """One (source, target) pair per scene."""

    num_views = 2
    nimg_mult = 1


class DualSourceCollate(_Collate):
    """Two sources sharing one target per scene."""

    num_views = 3
    nimg_mult = 6  # the reference counts +batch*6 images per step in dual mode


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
