#!/usr/bin/env python
"""Repo-root entry point of the PyTorch port: `python generate_images_torch.py ...`
(the counterpart of generate_images.py, on vivid_tpu_torch; the first CUDA
card unless --device cpu)."""
from vivid_tpu_torch.cli.generate_images import cmdline
from vivid_tpu_torch.diffusion.sampler import edm_sampler  # noqa: F401  (re-export, reference API)
from vivid_tpu_torch.generate import generate_images_nvs  # noqa: F401  (re-export, reference API)

if __name__ == "__main__":
    cmdline()
