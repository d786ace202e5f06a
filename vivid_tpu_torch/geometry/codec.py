"""Camera geometry codec: the 20-d conditioning vector.

Counterpart of vivid_tpu/geometry/codec.py: `compose_geometry_np` in
numpy for the collates, the rest on tensors (any leading dimensions):
`compose_K` / `decompose_K`, `compose_geometry` / `decompose_geometry`,
`resize_geometry`, `expand_extrinsics` and `relative_pose`. Layout:
flattened 3x4 relative pose tgt2src (12) + source fx,fy,cx,cy
(4) + target fx,fy,cx,cy (4), z-normalised with MEAN/STD; the intrinsic
slots are rescaled by imsize/64 (mean linearly, std quadratically), and
zero-STD slots (cx, cy) encode as 0. The constants are part of the trained
models' input contract.
"""

import numpy as np
import torch

MEAN = np.array([
    9.6681e-01, -1.6038e-04, -3.7034e-05, -1.6904e-03, -8.7718e-05,
    9.9869e-01, 3.1288e-03, -1.0794e-03, 1.0653e-05, 3.0997e-03,
    9.6691e-01, 1.2561e-02, 5.7708e+01, 5.7704e+01, 3.2000e+01,
    3.2000e+01, 5.7708e+01, 5.7704e+01, 3.2000e+01, 3.2000e+01,
], dtype=np.float32)
STD = np.array([
    0.1104, 0.0346, 0.2279, 0.4930, 0.0347, 0.0091, 0.0367, 0.2208, 0.2279,
    0.0368, 0.1088, 1.0751, 6.6464, 6.6511, 0.0000, 0.0000, 6.6464, 6.6511,
    0.0000, 0.0000,
], dtype=np.float32)


def compose_geometry_np(tgt2src, src_K, tgt_K, imsize=64):
    """Pack relative pose [..., 3, 4] + intrinsic 4-vectors into a normalised
    [..., 20] vector."""
    tgt2src = np.asarray(tgt2src, np.float32)
    mean = MEAN.copy()
    std = STD.copy()
    scale = imsize / 64.0
    mean[12:] *= scale
    std[12:] *= scale ** 2
    flat = tgt2src.reshape(*tgt2src.shape[:-2], 12)
    geometry = np.concatenate([flat, np.asarray(src_K, np.float32),
                               np.asarray(tgt_K, np.float32)], -1)
    out = np.zeros_like(geometry)
    np.divide(geometry - mean, std, out=out, where=std > 0)
    return out


def _scaled_stats(imsize, like):
    """MEAN and STD with the intrinsic slots rescaled to `imsize`, as
    tensors of `like`'s dtype and device."""
    mean = torch.as_tensor(MEAN, dtype=like.dtype, device=like.device).clone()
    std = torch.as_tensor(STD, dtype=like.dtype, device=like.device).clone()
    scale = imsize / 64.0
    mean[12:] *= scale
    std[12:] *= scale ** 2
    return mean, std


def compose_K(K):
    """[..., 3, 3] intrinsics -> [..., 4] (fx, fy, cx, cy)."""
    return torch.stack((K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]), -1)


def decompose_K(t):
    """[..., 4] (fx, fy, cx, cy) -> [..., 3, 3] intrinsics."""
    fx, fy, cx, cy = t.unbind(-1)
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, zero, cx], -1),
                        torch.stack([zero, fy, cy], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def compose_geometry(tgt2src, src_K, tgt_K, imsize=64):
    """Relative pose [..., 3, 4] + intrinsic 4-vectors -> the normalised
    [..., 20] vector, on tensors."""
    tgt2src = torch.as_tensor(tgt2src)
    src_K = torch.as_tensor(src_K, dtype=tgt2src.dtype, device=tgt2src.device)
    tgt_K = torch.as_tensor(tgt_K, dtype=tgt2src.dtype, device=tgt2src.device)
    mean, std = _scaled_stats(imsize, tgt2src)
    geometry = torch.cat([tgt2src.reshape(*tgt2src.shape[:-2], 12), src_K, tgt_K], -1)
    return torch.where(std > 0, (geometry - mean) / torch.where(std > 0, std, 1.0),
                       torch.zeros_like(geometry))


def decompose_geometry(t, imsize=64):
    """Inverse of the packing, on a tensor [..., 20] ->
    (tgt2src [..., 3, 4], src_K [..., 3, 3], tgt_K [..., 3, 3])."""
    mean, std = _scaled_stats(imsize, t)
    t = t * std + mean
    return (t[..., :12].reshape(*t.shape[:-1], 3, 4), decompose_K(t[..., 12:16]),
            decompose_K(t[..., 16:20]))


def resize_geometry(geometry, _from, _to):
    """The geometry vector of an image of size `_from` re-encoded for size
    `_to` (the intrinsics scale linearly with the resolution)."""
    tgt2src, src_K, tgt_K = decompose_geometry(geometry, _from)
    scale = _to / _from
    src_K, tgt_K = src_K.clone(), tgt_K.clone()
    src_K[..., :2, :] *= scale
    tgt_K[..., :2, :] *= scale
    return compose_geometry(tgt2src, compose_K(src_K), compose_K(tgt_K), _to)


def expand_extrinsics(extrinsics):
    """[..., 3, 4] -> [..., 4, 4] homogeneous."""
    bottom = torch.tensor([0, 0, 0, 1], dtype=extrinsics.dtype, device=extrinsics.device)
    return torch.cat([extrinsics, bottom.expand(*extrinsics.shape[:-2], 1, 4)], -2)


def relative_pose(src_c2w, tgt_c2w):
    """tgt2src = inv(tgt_c2w) @ src_c2w for [..., 4, 4] camera-to-world
    matrices."""
    return torch.linalg.inv(tgt_c2w) @ src_c2w
