"""DINOv2 ViT backbone, for the FD-DINOv2 detector (and, later, the
DepthAnything depth model).

Counterpart of vivid_tpu/nn/dinov2.py as an `nn.Module` whose parameter
names are the original facebookresearch/dinov2 ones (`cls_token`,
`pos_embed`, `patch_embed.proj`, `blocks.{i}.norm1`, `.attn.qkv`,
`.attn.proj`, `.ls1.gamma`, `.norm2`, `.mlp.fc1`, `.mlp.fc2`, `.ls2.gamma`,
`norm`), so an original checkpoint loads with `load_state_dict`. The eval
forward of vits / vitb / vitl: patch embedding, [cls ‖ patches] + positions,
pre-norm attention and MLP blocks with layer scale after `proj` and `fc2`,
exact GELU, LayerNorm eps 1e-6, a final LayerNorm; no register tokens. The
position grid is interpolated once, at load (bicubic, no antialiasing: the
original `interpolate_pos_encoding`), so the forward takes one input size.
"""

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


@dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 14


VIT_SIZES = {
    "vits": ViTConfig(384, 12, 6),
    "vitb": ViTConfig(768, 12, 12),
    "vitl": ViTConfig(1024, 24, 16),
}


class LayerScale(nn.Module):
    def __init__(self, dim, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        return x * self.gamma


class Attention(nn.Module):
    def __init__(self, dim, num_heads, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)   # [B, H, N, d] each
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    def __init__(self, dim, num_heads, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = Attention(dim, num_heads, device=device)
        self.ls1 = LayerScale(dim, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = Mlp(dim, 4 * dim, device=device)
        self.ls2 = LayerScale(dim, device=device)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size,
                              device=device)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)   # [B, N, C]


class DinoViT(nn.Module):
    """A DINOv2 ViT for inputs of `grid * patch_size` pixels a side."""

    def __init__(self, cfg: ViTConfig, grid: int, device=None):
        super().__init__()
        self.cfg, self.grid = cfg, grid
        c = cfg.embed_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, c, device=device))
        self.patch_embed = PatchEmbed(cfg, device=device)
        self.blocks = nn.ModuleList(Block(c, cfg.num_heads, device=device)
                                    for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(c, eps=LN_EPS, device=device)

    def forward(self, x, out_indices: Optional[Sequence[int]] = None):
        """x: [B, 3, H, W] normalised, H = W = grid * patch_size.

        out_indices None: (class token [B, C], patch-token mean [B, C]) after
        the final norm. Else: the final-normed patch tokens [B, N, C] after
        each of those blocks, and the (grid, grid) shape (DPT's inputs)."""
        b = x.shape[0]
        tokens = self.patch_embed(x)
        if tokens.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"pos_embed holds {self.pos_embed.shape[1]} tokens, the "
                             f"input gives {tokens.shape[1] + 1}: interpolate the position "
                             "grid at load for this input size")
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)
        tokens = tokens + self.pos_embed
        if out_indices is None:
            for block in self.blocks:
                tokens = block(tokens)
            tokens = self.norm(tokens)
            return tokens[:, 0], tokens[:, 1:].mean(dim=1)
        out, want = [], set(out_indices)
        for i, block in enumerate(self.blocks):
            tokens = block(tokens)
            if i in want:
                out.append(self.norm(tokens)[:, 1:])
        return out, (self.grid, self.grid)


def interpolate_pos_embed(pos: torch.Tensor, grid: int) -> torch.Tensor:
    """[1, n*n + 1, C] -> [1, grid*grid + 1, C]: the patch positions resized
    as an n x n image (bicubic, no antialiasing, half-pixel), the class
    position kept."""
    c = pos.shape[-1]
    n_have = int(round((pos.shape[1] - 1) ** 0.5))
    if n_have == grid:
        return pos
    patch = pos[0, 1:].float().reshape(1, n_have, n_have, c).permute(0, 3, 1, 2)
    patch = F.interpolate(patch, size=(grid, grid), mode="bicubic", antialias=False,
                          align_corners=False)
    patch = patch.permute(0, 2, 3, 1).reshape(1, grid * grid, c)
    return torch.cat([pos[:, :1].float(), patch], dim=1)


def load_original_state_dict(model: DinoViT, sd, prefix: str = "") -> DinoViT:
    """Load an original-naming state dict (`prefix` is e.g. 'pretrained.'
    inside DepthAnythingV2 checkpoints) into `model`, the position grid
    interpolated to the model's; keys the forward does not use (the
    pretraining's `mask_token`) are dropped, every other one must match."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    sd.pop("mask_token", None)
    sd["pos_embed"] = interpolate_pos_embed(torch.as_tensor(sd["pos_embed"]), model.grid)
    model.load_state_dict({k: torch.as_tensor(v).float() for k, v in sd.items()},
                          strict=True)
    return model


def expected_vit_shapes(cfg: ViTConfig, num_tokens: int, prefix: str = ""):
    """key -> shape of an original-naming checkpoint with `num_tokens`
    positions (class token included)."""
    c = cfg.embed_dim
    sd = {
        f"{prefix}cls_token": (1, 1, c),
        f"{prefix}pos_embed": (1, num_tokens, c),
        f"{prefix}patch_embed.proj.weight": (c, 3, cfg.patch_size, cfg.patch_size),
        f"{prefix}patch_embed.proj.bias": (c,),
        f"{prefix}norm.weight": (c,), f"{prefix}norm.bias": (c,),
    }
    for i in range(cfg.depth):
        pre = f"{prefix}blocks.{i}"
        sd.update({
            f"{pre}.norm1.weight": (c,), f"{pre}.norm1.bias": (c,),
            f"{pre}.attn.qkv.weight": (3 * c, c), f"{pre}.attn.qkv.bias": (3 * c,),
            f"{pre}.attn.proj.weight": (c, c), f"{pre}.attn.proj.bias": (c,),
            f"{pre}.ls1.gamma": (c,), f"{pre}.ls2.gamma": (c,),
            f"{pre}.norm2.weight": (c,), f"{pre}.norm2.bias": (c,),
            f"{pre}.mlp.fc1.weight": (4 * c, c), f"{pre}.mlp.fc1.bias": (4 * c,),
            f"{pre}.mlp.fc2.weight": (c, 4 * c), f"{pre}.mlp.fc2.bias": (c,),
        })
    return sd
