"""Fréchet distance and the metrics computed from accumulated statistics.

Counterpart of vivid_tpu/metrics/frechet.py: FID = |mu1 - mu2|^2 +
tr(S1 + S2 - 2 sqrtm(S1 S2)). The JAX package takes `scipy.linalg.sqrtm`
of S1 S2 and the real part of the trace; that complex Schur decomposition
took 325 s at 4096 dimensions (joint FID) on the host of an H100 machine.
Only the trace is needed, and S1 S2 is similar to the symmetric
S1^1/2 S2 S1^1/2, so tr sqrtm(S1 S2) is the sum of the square roots of that
matrix's eigenvalues: two symmetric eigendecompositions, where eigenvalues
below the rounding floor (largest x dimension x eps) count as 0, as in a
pseudo-inverse. With full-rank covariances the two forms agree to ~1e-14
relative. With singular ones (fewer images than dimensions) this form
gives the exact value to rounding, where sqrtm's is off by up to ~1e-7.
"""

from typing import List

import numpy as np


def _floored(w):
    """Eigenvalues with those below the rounding floor set to 0."""
    return np.where(w > w.max() * len(w) * np.finfo(w.dtype).eps, w, 0.0)


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    m = np.square(mu1 - mu2).sum()
    w, v = np.linalg.eigh(sigma1)
    root1 = (v * np.sqrt(_floored(w))) @ v.T
    lam = _floored(np.linalg.eigvalsh(root1 @ sigma2 @ root1))
    return float(m + np.trace(sigma1) + np.trace(sigma2) - 2 * np.sqrt(lam).sum())


STAT_METRICS = ("fid", "fd_dinov2", "joint_fid", "joint_fd_dinov2",
                "stub_fid", "joint_stub_fid")


def calculate_metrics_from_stats_nvs(stats, ref,
                                     metrics: List[str] = ("fid", "fd_dinov2",
                                                           "joint_fid",
                                                           "joint_fd_dinov2",
                                                           "psnr"),
                                     verbose: bool = True) -> dict:
    """{metric: value} from the statistics of the generated images (`stats`)
    and of the reference (`ref`, a dict or the path of saved statistics);
    a metric without statistics on either side is skipped."""
    if isinstance(ref, str):
        from vivid_tpu_torch.metrics.stats import load_stats
        ref = load_stats(ref, verbose=verbose)
    results = {}
    for metric in metrics:
        if metric not in stats or (metric in STAT_METRICS and metric not in ref):
            if verbose:
                print(f"No statistics computed for {metric} -- skipping.")
            continue
        if verbose:
            print(f"Calculating {metric}...")
        if metric in STAT_METRICS:
            value = frechet_distance(stats[metric]["mu"], stats[metric]["sigma"],
                                     ref[metric]["mu"], ref[metric]["sigma"])
        else:
            value = float(np.asarray(stats[metric]["val"]).reshape(()))
        results[metric] = value
        if verbose:
            print(f"{metric} = {value:g}")
    return results
