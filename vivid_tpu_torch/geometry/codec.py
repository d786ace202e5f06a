"""Camera geometry codec: the 20-d conditioning vector.

Copy of the numpy part of vivid_tpu/geometry/codec.py (the collate's only
need), and `decompose_geometry` on tensors for the epipolar attention bias. Layout: flattened 3x4 relative pose tgt2src (12) + source fx,fy,cx,cy
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


def decompose_geometry(t, imsize=64):
    """Inverse of the packing, on a tensor [..., 20] ->
    (tgt2src [..., 3, 4], src_K [..., 3, 3], tgt_K [..., 3, 3])."""
    mean = torch.as_tensor(MEAN, dtype=t.dtype, device=t.device).clone()
    std = torch.as_tensor(STD, dtype=t.dtype, device=t.device).clone()
    scale = imsize / 64.0
    mean[12:] *= scale
    std[12:] *= scale ** 2
    t = t * std + mean

    def intrinsics(v):
        fx, fy, cx, cy = v.unbind(-1)
        zero, one = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack([torch.stack([fx, zero, cx], -1),
                            torch.stack([zero, fy, cy], -1),
                            torch.stack([zero, zero, one], -1)], -2)

    return (t[..., :12].reshape(*t.shape[:-1], 3, 4), intrinsics(t[..., 12:16]),
            intrinsics(t[..., 16:20]))
