"""EDM2 inverse-sqrt learning-rate schedule with a linear warm-up.

Counterpart of vivid_tpu/diffusion/lr.py, on host floats:
lr = ref_lr / sqrt(max(nimg / (ref_batches * batch_size), 1))
     * min(nimg / (rampup_Mimg * 1e6), 1).
"""

import math


def learning_rate_schedule(cur_nimg, batch_size, ref_lr=100e-4, ref_batches=70e3,
                           rampup_Mimg=10.0) -> float:
    lr = float(ref_lr)
    if ref_batches > 0:
        lr /= math.sqrt(max(cur_nimg / (ref_batches * batch_size), 1.0))
    if rampup_Mimg > 0:
        lr *= min(cur_nimg / (rampup_Mimg * 1e6), 1.0)
    return lr
