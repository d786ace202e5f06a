"""View collation into fixed-shape batches, and the threaded batch loader.

Copy of the parts of vivid_tpu/data/collate.py that sampling and training
use (numpy + PIL only). Dual-source: per scene, three random views become
two sources and one shared target: src [B, 2, h, w, 3], tgt [B, h, w, 3],
geometry [B, 2, 20]. Vanilla: two random views, one source and one target:
src [B, 1, h, w, 3], geometry [B, 1, 20]. With `sr_size`, each row also
carries the same views at that size (sr_src_image, sr_tgt_image,
sr_geometry) for the super-resolution stage. The random draws are the same
as the JAX package's for the same seed, so both packages see the same
batches. Images come out as float32 in [0, 255], resized as the JAX
package resizes them (native/fast_image.py).
"""

import os
import queue
import random as _random
import threading
from typing import Iterator, Optional

import numpy as np
import PIL.Image

from vivid_tpu_torch.core.trace import span
from vivid_tpu_torch.geometry.codec import compose_geometry_np
from vivid_tpu_torch.native import fast_image


def resize_image(img: np.ndarray, size: int) -> np.ndarray:
    """[H, W, 3] any-range float/uint8 -> [size, size, 3] float32, [0,255].
    Whole-factor downscales of a square image are a box filter (the exact
    mean), other sizes the native bilinear resize; both the JAX package's,
    bit for bit. Under VIVID_NO_NATIVE=1 numpy's mean and PIL's uint8
    bilinear resize take their places, as in the JAX package without its
    native library."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        scale = 255.0 if arr.max() < 2.0 else 1.0
        arr = np.clip(arr * scale, 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    native = not fast_image.native_disabled()
    if h == w and h != size and h % size == 0:
        f = h // size
        if native:
            return fast_image.resize_box_u8(arr, f)
        return arr.reshape(size, f, size, f, 3).mean(axis=(1, 3), dtype=np.float32)
    if h != size or w != size:
        if native:
            return fast_image.resize_bilinear_u8(arr, size)
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


def default_loader_threads() -> int:
    """VIVID_LOADER_THREADS, else min(4, cpus) + 1, as in the JAX package."""
    return int(os.environ.get("VIVID_LOADER_THREADS", min(4, os.cpu_count() or 1) + 1))


class BatchLoader:
    """Background batch assembler: draws scenes from an (infinite) iterator,
    collates rows, stacks exactly `batch_size` of them, and prefetches
    batches so host IO overlaps device compute.

    `num_threads` workers (default `default_loader_threads()`) share the
    work. A worker draws the next scene and its plan (every random draw of
    the collate) under a lock, so plans follow the stream in order; it
    materialises the rows (decode, resize) outside the lock; then it waits
    for its turn and appends the rows in stream order. So the batches are
    the one-thread loader's bit for bit, for any thread count, and at most
    `num_threads` scenes are in flight. A scene that fails to decode gives
    no rows, as in the reference. A finite iterator's tail batch is padded by
    repeating its last row; `valid` marks the real rows, and every row of the
    stream comes out exactly once. `skip_rows` replays the draws of that many
    rows (no pixel work) before the first batch: a resumed run continues the
    stream where the earlier one stopped. Each `next` is a `loader.wait` span
    (`core/trace.py`, attribute `rows`): the caller's time blocked on the
    prefetch queue."""

    def __init__(self, scene_iter: Iterator, collate, batch_size: int,
                 prefetch: int = 4, num_threads: Optional[int] = None, skip_rows: int = 0):
        self.scene_iter = scene_iter
        self.collate = collate
        self.batch_size = batch_size
        self.queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._draw_lock = threading.Lock()      # the stream and the collate's draws
        self._turn = threading.Condition()      # rows appended in stream order
        self._drawn = 0                         # scenes drawn so far
        self._appended = 0                      # scenes whose rows are in `_pending`
        self._end = None                        # the stream's scene count, once known
        self._finished = False
        self._pending = []
        skipped = 0
        while skipped < skip_rows:
            scene = next(self.scene_iter)
            plan = self.collate.sample_plan(scene)
            if skipped + len(plan) > skip_rows:   # the boundary falls inside a scene
                self._pending = self.collate.materialize(scene, plan[skip_rows - skipped:])
            skipped = min(skipped + len(plan), skip_rows)
        self.threads = [threading.Thread(target=self._worker, daemon=True)
                        for _ in range(num_threads or default_loader_threads())]
        for t in self.threads:
            t.start()

    def _draw(self):
        """(sequence number, scene, plan) of the next scene, or None at the
        end of the stream."""
        with self._draw_lock:
            if self._end is not None:
                return None
            try:
                scene = next(self.scene_iter)
            except StopIteration:
                self._end = self._drawn
                return None
            seq, self._drawn = self._drawn, self._drawn + 1
            try:
                plan = self.collate.sample_plan(scene)
            except Exception:
                plan = None
            return seq, scene, plan

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _emit(self, final: bool):
        """Hand out every full batch of `_pending`; with `final`, the padded
        tail and the end mark. Called under `_turn`."""
        while len(self._pending) >= self.batch_size or (final and self._pending):
            rows = self._pending[:self.batch_size]
            self._pending = self._pending[self.batch_size:]
            n_valid = len(rows)
            rows += [rows[-1]] * (self.batch_size - n_valid)
            batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
            batch["valid"] = np.arange(self.batch_size) < n_valid
            if not self._put(batch):
                return
        if final and not self._finished:
            self._finished = True
            self._put(None)

    def _worker(self):
        while not self._stop.is_set():
            drawn = self._draw()
            if drawn is None:
                with self._turn:
                    self._turn.wait_for(lambda: self._appended == self._end
                                        or self._stop.is_set())
                    if not self._stop.is_set():
                        self._emit(final=True)
                return
            seq, scene, plan = drawn
            try:
                rows = self.collate.materialize(scene, plan) if plan else []
            except Exception:
                rows = []   # skip a scene that fails to decode, as the reference does
            with self._turn:
                self._turn.wait_for(lambda: self._appended == seq or self._stop.is_set())
                if self._stop.is_set():
                    return
                self._pending.extend(rows)
                self._appended += 1
                self._emit(final=False)
                self._turn.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        with span("loader.wait") as waited:
            item = self.queue.get()
            waited.attrs["rows"] = 0 if item is None else self.batch_size
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        with self._turn:
            self._turn.notify_all()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
