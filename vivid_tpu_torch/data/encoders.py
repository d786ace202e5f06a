"""Pixel <-> latent codec.

Counterpart of vivid_tpu/data/encoders.py: uint8 pixels map to roughly
unit-variance latents x/127.5 - 1 and back as clip(x*127.5 + 128, 0, 255)
-> uint8. Channel-last; accepts numpy arrays or tensors.
"""

import numpy as np
import torch


class StandardRGBEncoder:
    def encode_latents(self, x, device="cpu"):
        """[..., 3] pixels in [0, 255] -> float32 latents on `device`."""
        x = torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x)
        return x.to(device=device, dtype=torch.float32) / 127.5 - 1.0

    def decode(self, x):
        """Latents -> uint8 numpy pixels."""
        x = torch.as_tensor(x).float() * 127.5 + 128.0
        return x.clamp(0, 255).to(torch.uint8).cpu().numpy()
