"""DINOv2 ViT-L/14 for FD-DINOv2: the checkpoint, the preprocessing, the
features.

Counterpart of vivid_tpu/metrics/dinov2_jax.py. The reference resizes to
224 px with `F.interpolate(mode="bicubic", antialias=True)`, scales to
[0, 1], normalises with ImageNet's mean and std and takes the final-norm
class token (1024-d). Here all of it runs on the device, the resize through
that same call (the JAX package's `metrics/resize_jax.py` re-implemented it
and is not needed). The weights are the torch-hub checkpoint
`dinov2_vitl14_pretrain.pth`, read as a state dict (no hub code runs); its
37 x 37 position grid (518 px) is interpolated to 16 x 16 (224 px) at load.
"""

import os

import torch
import torch.nn.functional as F

from vivid_tpu_torch.nn.dinov2 import VIT_SIZES, DinoViT, load_original_state_dict

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INPUT_SIZE = 224
FEATURE_DIM = 1024


def find_checkpoint(weights_dir):
    for cand in (
        os.path.join(weights_dir, "torch_hub", "checkpoints", "dinov2_vitl14_pretrain.pth"),
        os.path.join(weights_dir, "dinov2_vitl14_pretrain.pth"),
    ):
        if os.path.exists(cand):
            return cand
    return None


def load_dinov2_vitl14(path, device="cpu") -> DinoViT:
    """The ViT-L/14 of the checkpoint at `path`, for 224 px inputs, in eval
    mode on `device`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    cfg = VIT_SIZES["vitl"]
    model = DinoViT(cfg, grid=INPUT_SIZE // cfg.patch_size, device="meta")
    model = model.to_empty(device="cpu")
    load_original_state_dict(model, sd)
    return model.to(device).eval().requires_grad_(False)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] in [0, 255] (any dtype, on any device) -> [N, 3, 224, 224]
    fp32, ImageNet-normalised."""
    x = images.float().permute(0, 3, 1, 2)
    if x.shape[-2:] != (INPUT_SIZE, INPUT_SIZE):
        x = F.interpolate(x, size=(INPUT_SIZE, INPUT_SIZE), mode="bicubic", antialias=True)
    x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).reshape(1, -1, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).reshape(1, -1, 1, 1)
    return (x - mean) / std


def dinov2_features(model: DinoViT, images: torch.Tensor, use_bf16: bool = False):
    """[N, H, W, 3] pixels on the model's device -> [N, 1024] fp32 class
    tokens; with `use_bf16`, the ViT under bf16 autocast (its products in
    bf16, LayerNorm and softmax statistics in fp32)."""
    x = preprocess(images)
    with torch.no_grad(), torch.autocast(x.device.type, dtype=torch.bfloat16,
                                         enabled=use_bf16):
        cls, _ = model(x)
    return cls.float()
