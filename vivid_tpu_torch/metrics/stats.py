"""Feature moments of generated and reference images, and PSNR.

Counterpart of vivid_tpu/metrics/stats.py. For each detector metric, fp64
running sums of the features and of their outer products, over the
generated images and over the targets (the reference), and for a `joint_`
metric the same over [features ‖ source-view features]; PSNR as a running
sum. The detectors run on the device; the fp64 sums stay on the host, one
`f.T @ f` a batch, and are summed over processes once, at the last batch
(core/dist.py). The iterable yields (r, ref) per batch; `r.stats` and
`ref.stats` are filled at the last one: {metric: {mu, sigma}} and
{"psnr": {val}}, plus num_images.
"""

import pickle
from typing import List, Optional

import numpy as np

from vivid_tpu_torch.core import dist
from vivid_tpu_torch.core.easydict import EasyDict
from vivid_tpu_torch.metrics.detectors import get_detector, metric_specs


def psnr(a, b):
    """Per-image PSNR of images [N, H, W, C] in [0, 255]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = ((a - b) ** 2).mean(axis=(1, 2, 3))
    return 10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12))


def calculate_stats_for_iterable_nvs(
    image_iter,
    metrics: List[str] = ("fid", "fd_dinov2", "joint_fid", "joint_fd_dinov2", "psnr"),
    verbose: bool = True,
    dest_path: Optional[str] = None,
    device=None,
):
    """image_iter yields EasyDicts with .images / .tgt / .src (NHWC, [0, 255])
    and has a len(). Detectors run on `device` (None: the first CUDA card).
    With `dest_path`, rank 0 saves the generated images' statistics there."""
    metrics = list(metrics)
    num_batches = len(image_iter)
    for metric in metrics:
        if metric not in metric_specs:
            raise ValueError(f"unknown metric {metric!r}; known: {sorted(metric_specs)}")
        if metric.startswith("joint_") and metric[len("joint_"):] not in metrics:
            raise ValueError(f"{metric} requires {metric[len('joint_'):]}")
    detectors = {m: get_detector(m, verbose=verbose, device=device)
                 for m in metrics if "detector_class" in metric_specs[m]
                 and not m.startswith("joint_")}
    if verbose:
        dist.print0("Calculating feature statistics...")

    class StatsIterable:
        def __len__(self):
            return num_batches

        def __iter__(self):
            state = [EasyDict(metric=m, detector=d) for m, d in detectors.items()]
            ref_state = [EasyDict(metric=m, detector=d) for m, d in detectors.items()]
            for s in state + ref_state:
                dim = s.detector.feature_dim
                s.cum_mu = np.zeros(dim, np.float64)
                s.cum_sigma = np.zeros((dim, dim), np.float64)
                if "joint_" + s.metric in metrics:
                    s.j_cum_mu = np.zeros(dim * 2, np.float64)
                    s.j_cum_sigma = np.zeros((dim * 2, dim * 2), np.float64)
            cum_psnr = 0.0
            cum_images = 0
            cum_tgt = 0

            def accumulate(s, f, prefix=""):
                s[prefix + "cum_mu"] += f.sum(0)
                s[prefix + "cum_sigma"] += f.T @ f

            def update(s, sref, images, tgt, src):
                f = np.asarray(s.detector(images), np.float64)
                tf = np.asarray(s.detector(tgt), np.float64)
                accumulate(s, f)
                accumulate(sref, tf)
                if "joint_" + s.metric in metrics:
                    sf = np.asarray(s.detector(src), np.float64)
                    accumulate(s, np.concatenate([f, sf], -1), "j_")
                    accumulate(sref, np.concatenate([tf, sf], -1), "j_")

            for batch_idx, data in enumerate(image_iter):
                images, tgt, src = data.get("images"), data.get("tgt"), data.get("src")
                if images is not None and tgt is not None:
                    for s, sref in zip(state, ref_state):
                        update(s, sref, images, tgt, src)
                    cum_images += np.asarray(images).shape[0]
                    cum_tgt += np.asarray(tgt).shape[0]
                    if "psnr" in metrics:
                        cum_psnr += psnr(images, tgt).sum()

                r = EasyDict(stats=None, images=images, batch_idx=batch_idx,
                             num_batches=num_batches)
                ref = EasyDict(stats=None, batch_idx=batch_idx, num_batches=num_batches)
                if batch_idx == num_batches - 1:
                    n_img = int(dist.all_reduce_sum(np.asarray([cum_images]))[0])
                    n_tgt = int(dist.all_reduce_sum(np.asarray([cum_tgt]))[0])
                    r.num_images, ref.num_images = n_img, n_tgt
                    if n_img < 2:
                        raise ValueError(f"{n_img} image(s): covariance statistics need >= 2")
                    r.stats = dict(num_images=n_img)
                    ref.stats = dict(num_images=n_tgt)

                    def reduce_into(stats_dict, slist, n):
                        for s in slist:
                            for prefix, name in (("", s.metric), ("j_", "joint_" + s.metric)):
                                if prefix and name not in metrics:
                                    continue
                                mu = dist.all_reduce_sum(s[prefix + "cum_mu"]) / n
                                sigma = (dist.all_reduce_sum(s[prefix + "cum_sigma"])
                                         - np.outer(mu, mu) * n) / (n - 1)
                                stats_dict[name] = dict(mu=mu, sigma=sigma)

                    reduce_into(r.stats, state, n_img)
                    reduce_into(ref.stats, ref_state, n_tgt)
                    if "psnr" in metrics:
                        total = dist.all_reduce_sum(np.asarray([cum_psnr]))[0]
                        r.stats["psnr"] = dict(val=total / n_img)
                    if dest_path is not None and dist.get_rank() == 0:
                        save_stats(r.stats, dest_path)
                yield r, ref

    return StatsIterable()


def save_stats(stats, path, verbose=False):
    with open(path, "wb") as f:
        pickle.dump(stats, f)
    if verbose:
        print(f"Saved statistics to {path}")


def load_stats(path, verbose=False):
    if verbose:
        print(f"Loading statistics from {path}")
    with open(path, "rb") as f:
        return pickle.load(f)
