"""Depth conditioning: DepthAnythingV2's input preparation, inference and
resize, and the depth channel appended to the source views.

Counterpart of vivid_tpu/geometry/depth.py. Any callable `depth_model`
[B, H, W, 3] normalised -> [B, h, w] (or [B, h, w, 1]) works;
`resolve_depth_model` builds DepthAnythingV2 (geometry/depth_anything.py)
for 'small' | 'base' | 'large' from the released metric-hypersim checkpoint
in $VIVID_DEPTH_DIR. Both resizes are antialiased: that is what matches
`jax.image.resize` (bicubic with Keys a = -0.5 up to 518 px, bilinear with
an antialiasing kernel down to the views' size); PyTorch's resizes without
antialiasing use a = -0.75 and no kernel widening.
"""

import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INV_DEPTH_MEAN, INV_DEPTH_STD = 0.4947, 0.2294   # the reference's recorded constants


def _resize(x, size, mode):
    """[B, H, W, C] -> [B, size[0], size[1], C], antialiased, half-pixel."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode=mode, antialias=True,
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def depth_prepare(x, size: int = 518):
    """[B, H, W, 3] in [0, 255] -> bicubic `size` square, ImageNet-normalised."""
    x = _resize(x.float() / 255.0, (size, size), "bicubic")
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def get_depth(depth_model: Callable, image, shape=None):
    """The depth model on `image` [B, H, W, 3] (pixels), resized bilinearly
    to `shape` (default the image's) -> [B, H, W, 1] float32."""
    shape = shape or image.shape[1:3]
    depth = depth_model(depth_prepare(image)).float()
    if depth.ndim == 3:
        depth = depth[..., None]
    return _resize(depth, shape, "bilinear")


def add_depth(depth_model: Callable, image, src, inv_norm: bool = False):
    """`src` [B, H, W, C] with the depth of `image` (its pixels) appended as
    one more channel. `inv_norm`: the reference's inverse-depth
    normalisation, (1 / d) / max over the view, then standardised."""
    depth = get_depth(depth_model, image, src.shape[1:3])
    if inv_norm:
        depth = 1.0 / depth
        depth = depth / depth.amax(dim=(1, 2, 3), keepdim=True)
        depth = (depth - INV_DEPTH_MEAN) / INV_DEPTH_STD
    return torch.cat([src, depth.to(src.dtype)], dim=-1)


def resolve_depth_model(depth_model, weights_dir: Optional[str] = None, device="cuda"):
    """None and callables pass through; 'small' | 'base' | 'large' builds
    DepthAnythingV2 on `device` from
    depth_anything_v2_metric_hypersim_{vits,vitb,vitl}.pth in `weights_dir`
    (default $VIVID_DEPTH_DIR, else the working directory). A missing file
    raises FileNotFoundError naming its path."""
    if depth_model is None or callable(depth_model):
        return depth_model
    from vivid_tpu_torch.geometry.depth_anything import ENCODER_NAMES, load_depth_anything
    if depth_model not in ENCODER_NAMES:
        raise ValueError(f"Unknown depth model {depth_model!r}; expected one of "
                         f"{sorted(ENCODER_NAMES)} or a callable")
    fname = f"depth_anything_v2_metric_hypersim_{ENCODER_NAMES[depth_model]}.pth"
    path = os.path.join(weights_dir or os.environ.get("VIVID_DEPTH_DIR", "."), fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"DepthAnythingV2 weights not found at {path}. Put {fname} (the "
            "Depth-Anything-V2 metric hypersim release) in $VIVID_DEPTH_DIR, or pass "
            "a callable depth model.")
    return load_depth_anything(depth_model, path, device=device)
