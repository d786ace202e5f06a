"""A RealEstate10K txt + png tree as a stream of scenes, and the factory that
opens a scene dataset by its layout.

Copy of vivid_tpu/data/re10k_scenes.py. `RealEstate10KScenes` yields the
scene records of the .npz `SceneDataset` (image [V, H, W, 3] uint8, c2w
[V, 4, 4], fxfycxcy [V, 4] in the geometry codec's 64-px convention),
sampling V frames of a sequence at each visit, so the vanilla and
dual-source collates read RealEstate10K directly, `range_selection` ('mid',
'long') included. Frames are centre-cropped squares, decoded only when a
collate indexes them (`LazyFrames`); the crop boxes and intrinsics come from
the PNG headers. The draws come from `random.Random(seed + process_index)`
in the JAX package's order, so one seed picks the same frames in both.
"""

import os
import random
from glob import glob
from typing import Iterator, Optional

import numpy as np

from vivid_tpu_torch.data.re10k import RANGE_SELECTIONS, parse_line, read_lines
from vivid_tpu_torch.native.fast_image import load_rgb, probe_dims


class LazyFrames:
    """Array-like [V, H, W, 3] uint8 over frame files, decoding and cropping
    a frame only when indexed (a dual-source row reads 3 of the V)."""

    def __init__(self, paths, crops):
        self.paths = list(paths)
        self.crops = list(crops)  # (top, left, size) per frame
        self._cache = {}
        size0 = self.crops[0][2] if self.crops else 0
        self.shape = (len(self.paths), size0, size0, 3)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        i = int(i)
        if i not in self._cache:
            top, left, size = self.crops[i]
            img = load_rgb(self.paths[i])
            self._cache[i] = img[top:top + size, left:left + size]
        return self._cache[i]

    def __array__(self, dtype=None, copy=None):
        arr = np.stack([self[i] for i in range(len(self))])
        return arr.astype(dtype) if dtype is not None else arr


class RealEstate10KScenes:
    """Infinite stream of scenes from `path`: the data root holding
    `RealEstate10K/<split>`, or that `RealEstate10K` directory itself."""

    def __init__(self, path: str, split: str = "train", views_per_scene: int = 8,
                 range_selection: Optional[str] = None, seed: int = 0,
                 shuffle: bool = True, process_index: int = 0,
                 process_count: int = 1, num_channels: int = 3, **unknown):
        if unknown:
            raise ValueError(f"RealEstate10KScenes does not take {sorted(unknown)}")
        if range_selection is not None and range_selection not in RANGE_SELECTIONS:
            raise ValueError(f"range_selection {range_selection!r} is not one of "
                             f"{sorted(RANGE_SELECTIONS)}")
        root = path
        if os.path.isdir(os.path.join(path, "RealEstate10K")):
            seq_dir = os.path.join(path, "RealEstate10K", split)
        else:
            seq_dir = os.path.join(path, split)
            root = os.path.dirname(path)
        self.frame_root = os.path.join(root, split)
        self.files = [p for p in sorted(glob(os.path.join(seq_dir, "*.txt")))
                      if os.path.isdir(os.path.join(self.frame_root,
                                                    os.path.basename(p)[:-4]))]
        if not self.files:
            raise IOError(f"No RealEstate10K sequences under {path!r} ({split})")
        self.views_per_scene = views_per_scene
        self.range_selection = range_selection
        self.rng = random.Random(seed + process_index)
        self.shuffle = shuffle
        self.process_index = process_index
        self.process_count = process_count
        self.num_channels = num_channels

    def __len__(self):
        return len(self.files)

    def _sample_frame_indices(self, n: int):
        v = min(self.views_per_scene, n)
        if self.range_selection is None:
            return sorted(self.rng.sample(range(n), v))
        s, e = RANGE_SELECTIONS[self.range_selection]
        # An anchor, a partner [s, e) frames away, then frames within e of
        # either until there are V.
        i1 = self.rng.randrange(n)
        window = [j for j in range(n) if s <= abs(j - i1) < e]
        if not window:
            return sorted(self.rng.sample(range(n), v))
        chosen = {i1, self.rng.choice(window)}
        pool = [j for j in range(n)
                if min(abs(j - c) for c in chosen) < e and j not in chosen]
        while len(chosen) < v and pool:
            j = self.rng.choice(pool)
            chosen.add(j)
            pool.remove(j)
        return sorted(chosen)

    def _load_scene(self, seq_path: str) -> Optional[dict]:
        seq = os.path.basename(seq_path)[:-4]
        lines = read_lines(seq_path)
        if len(lines) < 2:
            return None
        paths, crops, c2ws, ks = [], [], [], []
        for i in self._sample_frame_indices(len(lines)):
            ts, K, w2c = parse_line(lines[i])
            frame = os.path.join(self.frame_root, seq, ts + ".png")
            if not os.path.exists(frame):
                continue
            h, w = probe_dims(frame)
            crop = min(h, w)
            top, left = (h - crop) // 2, (w - crop) // 2
            Kc = K.copy()
            Kc[:2, 2] -= np.array([left, top])
            Kc[:2] *= 64.0 / crop  # the codec's 64-px intrinsics convention
            c2w = np.linalg.inv(np.concatenate([w2c, [[0, 0, 0, 1.0]]], 0))
            paths.append(frame)
            crops.append((top, left, crop))
            c2ws.append(c2w.astype(np.float32))
            ks.append(np.array([Kc[0, 0], Kc[1, 1], Kc[0, 2], Kc[1, 2]], np.float32))
        if len(paths) < 2:
            return None
        return dict(image=LazyFrames(paths, crops), c2w=np.stack(c2ws),
                    fxfycxcy=np.stack(ks))

    def __iter__(self) -> Iterator[dict]:
        order = list(range(len(self.files)))
        while True:
            if self.shuffle:
                self.rng.shuffle(order)
            for idx in order[self.process_index::self.process_count]:
                scene = self._load_scene(self.files[idx])
                if scene is not None:
                    yield scene


RE10K_ONLY_KEYS = ("split", "range_selection", "views_per_scene")


def open_scene_dataset(path: str, **kwargs):
    """The scene dataset under `path`: a RealEstate10K txt + png tree or a
    directory of scene .npz files, told apart by the layout. An .npz
    directory has no split, frame ranges or per-scene view count, so those
    keys are dropped for it; every other key goes on, and a key the dataset
    does not take raises by name."""
    if (os.path.isdir(os.path.join(path, "RealEstate10K"))
            or (os.path.basename(os.path.normpath(path)) == "RealEstate10K"
                and os.path.isdir(os.path.join(path, kwargs.get("split", "train"))))):
        return RealEstate10KScenes(path, **kwargs)
    from vivid_tpu_torch.data.scenes import SceneDataset
    return SceneDataset(path, **{k: v for k, v in kwargs.items() if k not in RE10K_ONLY_KEYS})
