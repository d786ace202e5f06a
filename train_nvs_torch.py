#!/usr/bin/env python
"""Repo-root entry point of the PyTorch port: `python train_nvs_torch.py ...`
(the counterpart of train_nvs.py, on vivid_tpu_torch; the first CUDA card
unless --device cpu)."""
from vivid_tpu_torch.cli.train_nvs import cmdline

if __name__ == "__main__":
    cmdline()
