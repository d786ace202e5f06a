"""DepthAnythingV2 (metric): a DINOv2 ViT backbone and the DPT head.

Counterpart of vivid_tpu/geometry/depth_anything.py as an `nn.Module` whose
parameter names are those of the original checkpoints
(depth_anything_v2_metric_hypersim_{vits,vitb,vitl}.pth): the backbone
`pretrained` (nn/dinov2.py's DinoViT, which takes the final-normed patch
tokens of four blocks) and `depth_head` (`projects.{i}`, `resize_layers.{0,1,3}`,
`scratch.layer{n}_rn`, `scratch.refinenet{n}.{resConfUnit1,resConfUnit2,out_conv}`,
`scratch.output_conv1`, `scratch.output_conv2.{0,2}`), so a checkpoint loads
with `load_depth_anything`. The deepest fusion stage has no second input and
does not use its `resConfUnit1`; it stays a parameter, so that loading is
strict. All resizes in the head are bilinear with align_corners=True.

Input: [B, H, W, 3] ImageNet-normalised (geometry/depth.py `depth_prepare`),
H = W = grid x 14 (518 px, grid 37, in the pipeline). Output: [B, H, W]
metric depth, sigmoid x max_depth.
"""

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vivid_tpu_torch.nn.dinov2 import (DinoViT, ViTConfig, expected_vit_shapes,
                                       load_original_state_dict)


@dataclass(frozen=True)
class DAV2Config:
    embed_dim: int
    depth: int
    num_heads: int
    layer_idx: Tuple[int, ...]      # blocks whose outputs feed the DPT head
    features: int                   # fusion width
    out_channels: Tuple[int, ...]   # reassemble widths (shallow -> deep)
    patch_size: int = 14
    max_depth: float = 20.0         # metric-hypersim checkpoints


SIZES: Dict[str, DAV2Config] = {
    "small": DAV2Config(384, 12, 6, (2, 5, 8, 11), 64, (48, 96, 192, 384)),
    "base": DAV2Config(768, 12, 12, (2, 5, 8, 11), 128, (96, 192, 384, 768)),
    "large": DAV2Config(1024, 24, 16, (4, 11, 17, 23), 256, (256, 512, 1024, 1024)),
}
ENCODER_NAMES = {"small": "vits", "base": "vitb", "large": "vitl"}
INPUT_GRID = 37   # 518 px / 14


def _vit_cfg(cfg: DAV2Config) -> ViTConfig:
    return ViTConfig(embed_dim=cfg.embed_dim, depth=cfg.depth, num_heads=cfg.num_heads,
                     patch_size=cfg.patch_size)


def resize_ac(x, size):
    """Bilinear resize of [B, C, H, W] to `size` with align_corners=True, the
    DPT head's only resize."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, device=device)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features, device=None):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features, device)
        self.resConfUnit2 = ResidualConvUnit(features, device)
        self.out_conv = nn.Conv2d(features, features, 1, device=device)

    def forward(self, x, skip=None, size=None):
        """Adds the refined `skip` (a shallower map) to `x`, refines the sum
        and resizes it to `size` (twice its size when None)."""
        h = x if skip is None else x + self.resConfUnit1(skip)
        h = self.resConfUnit2(h)
        h = resize_ac(h, size if size is not None else (2 * h.shape[2], 2 * h.shape[3]))
        return self.out_conv(h)


class _Scratch(nn.Module):
    def __init__(self, cfg: DAV2Config, device=None):
        super().__init__()
        f, oc = cfg.features, cfg.out_channels
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(oc[i], f, 3, padding=1, bias=False, device=device))
            setattr(self, f"refinenet{i + 1}", FeatureFusionBlock(f, device))
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1, device=device)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(f // 2, 32, 3, padding=1, device=device), nn.ReLU(),
            nn.Conv2d(32, 1, 1, device=device), nn.Sigmoid())


class DPTHead(nn.Module):
    def __init__(self, cfg: DAV2Config, device=None):
        super().__init__()
        oc = cfg.out_channels
        self.projects = nn.ModuleList(nn.Conv2d(cfg.embed_dim, c, 1, device=device) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4, device=device),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2, device=device),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1, device=device)])
        self.scratch = _Scratch(cfg, device)
        self.patch_size = cfg.patch_size

    def forward(self, feats, grid):
        """feats: four [B, N, C] token maps (shallow -> deep) -> [B, 1, H, W]
        in (0, 1)."""
        maps = []
        for i, f in enumerate(feats):
            m = f.transpose(1, 2).reshape(f.shape[0], f.shape[2], *grid)
            m = self.resize_layers[i](self.projects[i](m))
            maps.append(getattr(self.scratch, f"layer{i + 1}_rn")(m))
        s = self.scratch
        h = s.refinenet4(maps[3], size=maps[2].shape[2:])
        h = s.refinenet3(h, maps[2], size=maps[1].shape[2:])
        h = s.refinenet2(h, maps[1], size=maps[0].shape[2:])
        h = s.refinenet1(h, maps[0])
        h = resize_ac(s.output_conv1(h), (grid[0] * self.patch_size, grid[1] * self.patch_size))
        return s.output_conv2(h)


class DepthAnythingV2(nn.Module):
    """DepthAnythingV2 for inputs of `grid` x 14 pixels a side."""

    def __init__(self, cfg: DAV2Config, grid: int = INPUT_GRID, device=None):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoViT(_vit_cfg(cfg), grid, device=device)
        self.depth_head = DPTHead(cfg, device)

    def forward(self, x):
        """[B, H, W, 3] normalised -> [B, H, W] metric depth."""
        feats, grid = self.pretrained(x.permute(0, 3, 1, 2), out_indices=self.cfg.layer_idx)
        return self.depth_head(feats, grid)[:, 0] * self.cfg.max_depth


def expected_state_dict_shapes(cfg: DAV2Config, num_tokens: int = 1370):
    """The original checkpoint's key -> shape contract (for stand-in
    checkpoints in tests and the smoke run)."""
    f, oc = cfg.features, cfg.out_channels
    sd = expected_vit_shapes(_vit_cfg(cfg), num_tokens, prefix="pretrained.")
    for i in range(4):
        sd[f"depth_head.projects.{i}.weight"] = (oc[i], cfg.embed_dim, 1, 1)
        sd[f"depth_head.projects.{i}.bias"] = (oc[i],)
        sd[f"depth_head.scratch.layer{i + 1}_rn.weight"] = (f, oc[i], 3, 3)
    sd["depth_head.resize_layers.0.weight"] = (oc[0], oc[0], 4, 4)
    sd["depth_head.resize_layers.0.bias"] = (oc[0],)
    sd["depth_head.resize_layers.1.weight"] = (oc[1], oc[1], 2, 2)
    sd["depth_head.resize_layers.1.bias"] = (oc[1],)
    sd["depth_head.resize_layers.3.weight"] = (oc[3], oc[3], 3, 3)
    sd["depth_head.resize_layers.3.bias"] = (oc[3],)
    for n in range(1, 5):
        rn = f"depth_head.scratch.refinenet{n}"
        for u in ("resConfUnit1", "resConfUnit2"):
            sd[f"{rn}.{u}.conv1.weight"] = (f, f, 3, 3)
            sd[f"{rn}.{u}.conv1.bias"] = (f,)
            sd[f"{rn}.{u}.conv2.weight"] = (f, f, 3, 3)
            sd[f"{rn}.{u}.conv2.bias"] = (f,)
        sd[f"{rn}.out_conv.weight"] = (f, f, 1, 1)
        sd[f"{rn}.out_conv.bias"] = (f,)
    sd["depth_head.scratch.output_conv1.weight"] = (f // 2, f, 3, 3)
    sd["depth_head.scratch.output_conv1.bias"] = (f // 2,)
    sd["depth_head.scratch.output_conv2.0.weight"] = (32, f // 2, 3, 3)
    sd["depth_head.scratch.output_conv2.0.bias"] = (32,)
    sd["depth_head.scratch.output_conv2.2.weight"] = (1, 32, 1, 1)
    sd["depth_head.scratch.output_conv2.2.bias"] = (1,)
    return sd


def load_checkpoint(model: DepthAnythingV2, sd) -> DepthAnythingV2:
    """An original-naming state dict into `model`: the ViT through
    `load_original_state_dict` (its position grid interpolated to the
    model's), the head strictly."""
    load_original_state_dict(model.pretrained, sd, prefix="pretrained.")
    head = {k[len("depth_head."):]: torch.as_tensor(v).float()
            for k, v in sd.items() if k.startswith("depth_head.")}
    model.depth_head.load_state_dict(head, strict=True)
    rest = sorted(k for k in sd if not k.startswith(("pretrained.", "depth_head.")))
    if rest:
        raise ValueError(f"unexpected keys in the depth checkpoint: {rest[:8]}")
    return model


def load_depth_anything(size: str, weights_path: str, device="cuda",
                        grid: int = INPUT_GRID) -> DepthAnythingV2:
    """A DepthAnythingV2 `size` ('small' | 'base' | 'large') from an original
    metric checkpoint (.pth), fp32, in eval mode on `device`: a callable
    [B, 14 grid, 14 grid, 3] normalised -> [B, 14 grid, 14 grid]."""
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and hasattr(sd["model"], "keys"):
        sd = sd["model"]
    model = DepthAnythingV2(SIZES[size], grid=grid, device="meta").to_empty(device="cpu")
    load_checkpoint(model, sd)
    return model.to(device).eval().requires_grad_(False)
