"""Feature detectors for FID and FD-DINOv2, and the metric table.

Counterpart of vivid_tpu/metrics/detectors.py. A detector maps NHWC images
in [0, 255] to [N, feature_dim] fp32 features (numpy). The reference fetches
its detector weights over the network; here they come from a local
directory, `$VIVID_DETECTOR_DIR` (default ~/.cache/vivid_tpu), and a missing
file raises FileNotFoundError with the JAX package's message:
`inception-2015-12-05.pkl` (NVIDIA's InceptionV3 pickle) and
`torch_hub/checkpoints/dinov2_vitl14_pretrain.pth` (or the file alone).
With VIVID_ALLOW_RANDOM_DETECTOR=1 the InceptionV3 runs on seeded random
weights instead, for plumbing and throughput checks: its FID values mean
nothing. DINOv2 has no such mode. `StubDetector` (numpy, no weights) keeps
the whole metric pipeline testable (`stub_fid`, `joint_stub_fid`).

The network detectors run on the first CUDA card (InceptionV3 in bf16,
channels-last; the ViT under bf16 autocast), or on the CPU in fp32 when the
caller passes device="cpu"; without a card and without that they raise.
"""

import os
from typing import Dict

import numpy as np
import torch

from vivid_tpu_torch.core import dist
from vivid_tpu_torch.core.easydict import EasyDict


def resolve_device(device=None) -> torch.device:
    """`device`, or the first CUDA card; RuntimeError when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA card found; pass device="cpu" (--device cpu) '
                               "to run the detectors on the CPU")
        device = "cuda"
    return torch.device(device)


class Detector:
    def __init__(self, feature_dim: int):
        self.feature_dim = feature_dim

    def __call__(self, x):  # NHWC [0, 255] -> [N, C] float32
        raise NotImplementedError


class StubDetector(Detector):
    """Deterministic detector: a fixed random projection of 16 x 16
    box-pooled pixels (identical image sets give identical moments, disjoint
    ones a nonzero Fréchet distance)."""

    def __init__(self, feature_dim: int = 64, seed: int = 0, device=None):
        super().__init__(feature_dim)
        rng = np.random.RandomState(seed)
        self.proj = rng.randn(16 * 16 * 3, feature_dim).astype(np.float32)

    def __call__(self, x):
        x = np.asarray(x, np.float32) / 255.0
        n, h, w, c = x.shape
        fh, fw = max(h // 16, 1), max(w // 16, 1)
        x = x[:, : fh * 16, : fw * 16]
        x = x.reshape(n, 16, fh, 16, fw, c).mean(axis=(2, 4))
        return x.reshape(n, -1) @ self.proj


def _weights_dir():
    return os.environ.get("VIVID_DETECTOR_DIR", os.path.expanduser("~/.cache/vivid_tpu"))


class InceptionV3Detector(Detector):
    """FID detector (2048-d): metrics/inception.py with the NVIDIA
    inception-2015-12-05 pickle's weights (which the reference downloads),
    or seeded random weights under VIVID_ALLOW_RANDOM_DETECTOR. The pixels
    are cast to uint8 on the host, as the JAX package casts them."""

    def __init__(self, device=None):
        super().__init__(feature_dim=2048)
        from vivid_tpu_torch.metrics.inception import InceptionV3
        self.device = resolve_device(device)
        model = InceptionV3(use_bf16=self.device.type == "cuda")
        if os.environ.get("VIVID_ALLOW_RANDOM_DETECTOR"):
            import warnings
            warnings.warn("VIVID_ALLOW_RANDOM_DETECTOR: InceptionV3 running "
                          "with RANDOM weights; FID values are meaningless")
            model.init_random(seed=0)
        else:
            path = os.path.join(_weights_dir(), "inception-2015-12-05.pkl")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"InceptionV3 detector weights not found at {path}. Download "
                    "inception-2015-12-05.pkl (NVIDIA stylegan3 metrics) into "
                    "$VIVID_DETECTOR_DIR to compute reference-comparable FID.")
            import pickle
            with open(path, "rb") as f:
                model.load_torch_module(pickle.load(f))
        self.model = model.to(self.device).eval().requires_grad_(False)

    def __call__(self, x):
        images = torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.uint8)))
        return self.model(images.to(self.device)).cpu().numpy()


class DINOv2Detector(Detector):
    """FD-DINOv2 detector (1024-d): the ViT-L/14 of nn/dinov2.py on the
    torch-hub checkpoint file, final-norm class token; the resize and
    normalisation on the device (metrics/dinov2.py)."""

    def __init__(self, device=None):
        super().__init__(feature_dim=1024)
        from vivid_tpu_torch.metrics.dinov2 import find_checkpoint, load_dinov2_vitl14
        self.device = resolve_device(device)
        path = find_checkpoint(_weights_dir())
        if path is None:
            raise FileNotFoundError(
                f"dinov2_vitl14_pretrain.pth not found under {_weights_dir()}"
                " (torch_hub/checkpoints/). Download the DINOv2 ViT-L/14 "
                "checkpoint into $VIVID_DETECTOR_DIR to compute FD-DINOv2.")
        self.model = load_dinov2_vitl14(path, device=self.device)

    def __call__(self, x):
        from vivid_tpu_torch.metrics.dinov2 import dinov2_features
        arr = np.asarray(x)
        if arr.dtype != np.uint8:   # uint8 crosses to the card as bytes; the rest as fp32
            arr = arr.astype(np.float32)
        images = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        return dinov2_features(self.model, images,
                               use_bf16=self.device.type == "cuda").cpu().numpy()


metric_specs = {
    "fid": EasyDict(detector_class=InceptionV3Detector),
    "fd_dinov2": EasyDict(detector_class=DINOv2Detector),
    "joint_fid": EasyDict(detector_class=InceptionV3Detector),
    "joint_fd_dinov2": EasyDict(detector_class=DINOv2Detector),
    "psnr": EasyDict(),
    # Pipeline-testing metrics with the stub detector:
    "stub_fid": EasyDict(detector_class=StubDetector),
    "joint_stub_fid": EasyDict(detector_class=StubDetector),
}

_detector_cache: Dict[tuple, Detector] = {}


def get_detector(metric: str, verbose: bool = True, device=None) -> Detector:
    """The metric's detector on `device` (None: the first CUDA card), built
    once a process."""
    key = (metric, None if device is None else str(torch.device(device)))
    if key in _detector_cache:
        return _detector_cache[key]
    cls = metric_specs[metric].detector_class
    if verbose:
        dist.print0(f"Setting up {cls.__name__}...")
    _detector_cache[key] = detector = cls(device=device)
    return detector
