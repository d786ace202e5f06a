"""Depth-based warping of pixel coordinates, for `warp_depth_coor` models.

Counterpart of the depth-warp half of vivid_tpu/geometry/warp.py
(`warp_image`, `get_warped_features`): unproject a pixel grid with predicted
depth, move it by the relative pose, reproject it, and encode both grids
with the model's logvar Fourier embedder into 128 coordinate channels (the
first 64 of each coordinate's features). The homography half (the single-
image camera rotations) is in data/single_images.py
(`random_camera_rotation`, `_bilinear_sample`, in numpy). Channel-last.
"""

import torch

from vivid_tpu_torch.geometry.codec import decompose_geometry


def _expand_extrinsics(extrinsics):
    """[..., 3, 4] -> [..., 4, 4] homogeneous."""
    bottom = torch.zeros(extrinsics.shape[:-2] + (1, 4), dtype=extrinsics.dtype,
                         device=extrinsics.device)
    bottom[..., 3] = 1
    return torch.cat([extrinsics, bottom], dim=-2)


def warp_image(depth, geometry, coords):
    """Project the target grid's pixel coordinates into the source view.

    depth [B, H, W, 1], geometry [B, 20], coords [B, H, W, 2] (x, y) ->
    warped [B, H, W, 2], NaNs zeroed."""
    tgt2src, src_K, tgt_K = decompose_geometry(geometry[:, None], imsize=coords.shape[-2])
    pts = torch.cat([coords, torch.ones_like(coords[..., :1])], dim=-1)   # [B, H, W, 3]
    w = pts @ torch.linalg.inv(src_K).transpose(-1, -2)
    w = torch.cat([w * depth, torch.ones_like(depth)], dim=-1)
    w = w @ torch.linalg.inv(_expand_extrinsics(tgt2src)).transpose(-1, -2)
    w = w[..., :3] @ tgt_K.transpose(-1, -2)
    warped = (w / w[..., 2:])[..., :2]
    return torch.where(torch.isnan(warped), torch.zeros_like(warped), warped)


def get_warped_features(depth, geometry, embed_fn):
    """Fourier features of the identity grid ((i, j) + 0.5) and of the
    depth-warped grid. `embed_fn` maps scalars [N] -> [N, C >= 64] (the
    model's `logvar_fourier`); the first 64 channels of each coordinate's
    features are kept, so (x, y) pack into 128.

    depth [B, H, W, 1] -> (features, warped_features), each [B, H, W, 128]."""
    b, h, w, _ = depth.shape
    ii, jj = torch.meshgrid(torch.arange(h, dtype=depth.dtype, device=depth.device),
                            torch.arange(w, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    grid = torch.stack([ii, jj], dim=-1)[None].expand(b, h, w, 2) + 0.5
    warped = warp_image(depth, geometry, grid)

    def encode(g):
        return embed_fn(g.reshape(-1))[..., :64].reshape(b, h, w, 128)

    return encode(grid), encode(warped)
