"""Depth-based warping and homographies, channel-last, on tensors.

Counterpart of vivid_tpu/geometry/warp.py:
  * `warp_image` and `get_warped_features`, for `warp_depth_coor` models:
    unproject a pixel grid with predicted depth, move it by the relative
    pose, reproject it, and encode both grids with the model's logvar
    Fourier embedder into 128 coordinate channels (the first 64 of each
    coordinate's features);
  * `bilinear_sample`, `warp_perspective` and `euler_to_rotation_matrix`,
    the single-image camera rotations (data/single_images.py). They follow
    the JAX package's order of operations on the CPU, so the single-image
    rows match its bits: the homography's inverse by LU, the projection
    summed as XLA's CPU matrix product sums it (its w row with the last two
    terms fused, which float64 gives here).
"""

import numpy as np
import scipy.linalg
import torch

from vivid_tpu_torch.geometry.codec import decompose_geometry, expand_extrinsics


def warp_image(depth, geometry, coords):
    """Project the target grid's pixel coordinates into the source view.

    depth [B, H, W, 1], geometry [B, 20], coords [B, H, W, 2] (x, y) ->
    warped [B, H, W, 2], NaNs zeroed."""
    tgt2src, src_K, tgt_K = decompose_geometry(geometry[:, None], imsize=coords.shape[-2])
    pts = torch.cat([coords, torch.ones_like(coords[..., :1])], dim=-1)   # [B, H, W, 3]
    w = pts @ torch.linalg.inv(src_K).transpose(-1, -2)
    w = torch.cat([w * depth, torch.ones_like(depth)], dim=-1)
    w = w @ torch.linalg.inv(expand_extrinsics(tgt2src)).transpose(-1, -2)
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


def bilinear_sample(image, coords):
    """Sample an [H, W, C] image at float pixel coords [..., 2] (x, y),
    bilinearly, zero outside."""
    h, w = image.shape[:2]
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    wx = (x - x0.to(x.dtype))[..., None]
    wy = (y - y0.to(y.dtype))[..., None]

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = image[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], vals, torch.zeros((), dtype=vals.dtype))

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def inverse_3x3(a):
    """The inverse of a 3x3 matrix. A float32 matrix on the CPU goes through
    LAPACK's LU (getrf) and two triangular solves (trsm), what the JAX
    package's `linalg.inv` runs on the CPU, so the bits are its; others
    through `torch.linalg.inv`."""
    if a.device.type != "cpu" or a.dtype != torch.float32:
        return torch.linalg.inv(a)
    lu, piv, _ = scipy.linalg.lapack.sgetrf(a.numpy())
    perm = np.arange(3)
    for i, p in enumerate(piv):
        perm[i], perm[p] = perm[p], perm[i]
    x = np.eye(3, dtype=np.float32)[perm]
    x = scipy.linalg.blas.strsm(1.0, lu, x, lower=1, diag=1)
    return torch.from_numpy(scipy.linalg.blas.strsm(1.0, lu, x, lower=0, diag=0))


def project(pts, m):
    """pts [..., 3] @ m.T in float32, summed in the order of the JAX
    package's CPU matrix product: its x and y rows in order, its w row with
    the last two terms fused (one rounding), which float64 gives here."""
    p = pts.unbind(-1)
    rows = [(p[0] * m[r, 0] + p[1] * m[r, 1]) + p[2] * m[r, 2] for r in range(2)]
    w = p[0] * m[2, 0]
    for k in (1, 2):
        w = (p[k].double() * m[2, k].double() + w).float()
    return torch.stack(rows + [w], -1)


def warp_perspective(image, H, out_shape=None):
    """An [H, W, C] image under the homography H (source pixel -> destination
    pixel): each destination pixel samples the source bilinearly at its
    inverse image (kornia's warp_perspective)."""
    h_out, w_out = out_shape or image.shape[:2]
    ii, jj = torch.meshgrid(torch.arange(h_out, dtype=image.dtype, device=image.device),
                            torch.arange(w_out, dtype=image.dtype, device=image.device),
                            indexing="ij")
    src = project(torch.stack([jj, ii, torch.ones_like(ii)], -1), inverse_3x3(H))
    return bilinear_sample(image, src[..., :2] / src[..., 2:])


def euler_to_rotation_matrix(pitch, yaw, roll):
    """R = Rx(pitch) Ry(yaw) Rz(roll) from angles in radians (kornia's
    quaternion_from_euler -> quaternion_to_rotation_matrix chain), float32.
    The cosines and sines are numpy's float32 ones: torch's round otherwise
    for about one angle in fifteen, and numpy's give the JAX package's rows
    in the single-image tests."""
    def rot(a, i, j):
        a = np.float32(a)
        c, s = float(np.cos(a)), float(np.sin(a))
        m = torch.eye(3, dtype=torch.float32)
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
        return m

    return rot(pitch, 1, 2) @ rot(yaw, 2, 0) @ rot(roll, 0, 1)
