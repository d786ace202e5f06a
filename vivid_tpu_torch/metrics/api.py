"""Metrics of a model in one call: generate, accumulate, compute.

Counterpart of vivid_tpu/metrics/api.py `get_metrics` (the reference's
calculate_metrics.get_metrics): `num_images` samples through
`generate_images_nvs`, their detector statistics, and the metrics, computed
on rank 0. Other ranks get None, and a caller must take that (the
trainer's metrics tick prints and records nothing then).
"""

from typing import List, Optional

from vivid_tpu_torch.core import dist
from vivid_tpu_torch.generate import generate_images_nvs
from vivid_tpu_torch.metrics.frechet import calculate_metrics_from_stats_nvs
from vivid_tpu_torch.metrics.stats import calculate_stats_for_iterable_nvs

DEFAULT_METRICS = ("fid", "fd_dinov2", "joint_fid", "joint_fd_dinov2", "psnr")


def get_metrics(net, encoder=None, num_images: int = 10_000,
                metrics: Optional[List[str]] = None, sr_model=None, depth_model=None,
                datakwargs=None, seed: int = 0, verbose: bool = False,
                max_batch_size: int = 25, device=None, **gen_kwargs) -> Optional[dict]:
    """{metric: value} on rank 0, None elsewhere. Sampling and detectors run
    on `device` (None: the first CUDA card)."""
    metrics = list(metrics or DEFAULT_METRICS)
    image_iter = generate_images_nvs(
        net=net, encoder=encoder, seeds=range(seed, seed + num_images),
        max_batch_size=max_batch_size, sr_model=sr_model, depth_model=depth_model,
        datakwargs=datakwargs, verbose=verbose, device=device, **gen_kwargs)
    stats_iter = calculate_stats_for_iterable_nvs(image_iter, metrics=metrics,
                                                  verbose=verbose, device=device)
    r = ref = None
    for r, ref in stats_iter:
        pass
    results = None
    if dist.get_rank() == 0 and r is not None:
        results = calculate_metrics_from_stats_nvs(stats=r.stats, ref=ref.stats,
                                                   metrics=metrics, verbose=verbose)
    dist.barrier()
    return results
