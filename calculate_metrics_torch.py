#!/usr/bin/env python
"""Repo-root entry point of the PyTorch port: `python calculate_metrics_torch.py ...`
(the counterpart of calculate_metrics.py, on vivid_tpu_torch; the first CUDA
card unless --device cpu)."""
from vivid_tpu_torch.cli.calculate_metrics import cmdline
from vivid_tpu_torch.metrics.api import get_metrics  # noqa: F401  (re-export, reference API)

if __name__ == "__main__":
    cmdline()
